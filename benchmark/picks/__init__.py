"""Which returned eigenpairs a solve is held to, one module each, named by
a traffic mix's ``targets.pick``: ``picks/<pick>.py`` has ``pick(ev,
levels, targets, tin)``, which returns (indices into ``ev``, the exact
levels they are held to, and a count gap or None)."""
