"""Problem families: DVR bases, synthetic spectra, product-basis operators."""
