"""Structured two-file text reporting for both eigensolvers.

Output contract parity with the reference (reference: printUtils.py): each run
writes a detailed file (``iterations_{lanczos,feast}.out``) and a
machine-parsable fixed-width summary (``summary_{lanczos,feast}.out``) wrapped
in ``startingPoint``/``endingPoint`` sentinel lines for downstream extractors
(reference: printUtils.py:77, :171, :331).  Labels handled by ``writeFile``:
overlap (+condition number), hamiltonian, eigenvalues, iteration, KSmaxD,
fitmaxD, results, summary (reference: printUtils.py:187-274).
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

from .subspace import find_nearest, nearest_degenerate
from .units import au2unit


def convert(arr, eShift=0.0, unit="au"):
    """Energy/matrix conversion with shift (reference: printUtils.py:9-18)."""
    if unit == "au":
        return np.asarray(arr) - eShift
    return au2unit(arr, unit) - eShift


class _ReporterBase:
    def __init__(self, writeOut, outFileName, summaryFileName, verbose=False):
        self.writeOut = writeOut
        self.verbose = verbose
        if writeOut:
            self.outfile = open(outFileName, "w")
            self.sumfile = open(summaryFileName, "w")
        else:
            self.outfile = None
            self.sumfile = None

    def close(self):
        for f in (self.outfile, self.sumfile):
            if f is not None:
                f.close()
        self.outfile = self.sumfile = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _emit(self, text, both=False, summary_only=False):
        if not self.writeOut:
            return
        if summary_only:
            self.sumfile.write(text)
        else:
            self.outfile.write(text)
            if both:
                self.sumfile.write(text)
        self.outfile.flush()
        self.sumfile.flush()

    @staticmethod
    def _stamp(msg):
        dateTime = datetime.now().strftime("%d/%m/%Y %H:%M:%S")
        return ("*" * 70 + f"\n\t\t{msg}\t\t\n\t\t" + dateTime + "\t\t\n"
                + "*" * 70 + "\n\n")

    def _solver_settings_block(self, options, formatStyle):
        """Backend-specific solver-settings header block
        (reference: printUtils.py:102-141)."""
        lines = ""
        optLinear = options.get("linearSystemArgs", {})
        if "linearSolver" in optLinear:  # dense backends
            lines += formatStyle.format("lsweep", optLinear.get("linearIter", "-"),
                                        "Max iterations: Linear solver") + "\n"
            lines += formatStyle.format("solver", optLinear.get("linearSolver", "-"),
                                        "Linear solver") + "\n"
            lines += formatStyle.format("ltol", optLinear.get("linear_tol", "-"),
                                        "Tolerance: Linear solver") + "\n"
        elif "nSweep" in optLinear:      # sweep-based (MPS) backends
            lines += formatStyle.format("lsweep", optLinear.get("nSweep", "-"),
                                        "Number of sweeps: Linear solver") + "\n"
            lines += formatStyle.format("ltol", optLinear.get("convTol", "-"),
                                        "Global tolerance: Linear solver") + "\n"
            lines += formatStyle.format("maxD", optLinear.get("maxD", -1),
                                        "Maximum bond dimension") + "\n"
            optFitting = options.get("stateFittingArgs", {})
            if optFitting:
                lines += formatStyle.format("ftol", optFitting.get("convTol", "-"),
                                            "Fitting tolerance") + "\n"
                lines += formatStyle.format("fsweep", optFitting.get("nSweep", "-"),
                                            "Number of sweeps: fitting") + "\n"
        return lines


class LanczosReporter(_ReporterBase):
    """Reporter for the inexact-Lanczos driver
    (parity: reference printUtils.py:23-274, class LanczosPrintUtils)."""

    def __init__(self, guessVector, sigma, L, maxit, eConv, checkFitTol,
                 writeOut, eShift, convertUnit, pick, status,
                 outFileName=None, summaryFileName=None):
        super().__init__(writeOut,
                         outFileName or "iterations_lanczos.out",
                         summaryFileName or "summary_lanczos.out")
        self.options = guessVector.options
        self.sigma = sigma
        self.L = L
        self.maxit = maxit
        self.eConv = eConv
        self.checkFitTol = checkFitTol
        self.eShift = eShift
        self.convertUnit = convertUnit
        self.pick = pick
        self.status = status

    def fileHeader(self):
        if not self.writeOut:
            return
        self._emit("startingPoint\n", summary_only=True)
        lines = self._stamp("Starting computation")
        nBlock = self.status["nBlock"]
        lines += f"# Inexact Lanczos with {nBlock} guess vectors\n\n"

        formatStyle = "{:12} {:>14} :: {:20}"
        target = convert(self.sigma, self.eShift, self.convertUnit)
        lines += formatStyle.format("target", f"{target:.2f}", "target excitation") + "\n"
        lines += formatStyle.format("L", self.L, "Krylov space") + "\n"
        lines += formatStyle.format("maxit", self.maxit, "Maximum Lanczos iterations") + "\n"
        lines += formatStyle.format("econv", f"{self.eConv:.03g}", "Eigenvalue convergence") + "\n"
        lines += formatStyle.format("checkFitTol", self.checkFitTol, "Checkfit tolerance") + "\n"
        pickname = getattr(self.pick, "__qualname__", str(self.pick))
        lines += "{:10} {:>20}".format("pick", pickname) + "\n"
        lines += self._solver_settings_block(self.options, formatStyle)
        lines += formatStyle.format("Phase", self.status["phase"],
                                    "Stage of phase calculation") + "\n\n"
        self._emit(lines, both=True)

        header = "{:>4} {:>6} {:>6} {:>12}".format("it", "i", "nCum", "target")
        for iBlock in range(nBlock):
            header += "{:>18}".format("EvalueBlock" + str(iBlock + 1))
        header += "{:>16} {:>16}".format("residual", "time(seconds)\n")
        self._emit(header, summary_only=True)

    def fileFooter(self):
        if not self.writeOut:
            return
        self._emit("endingPoint\n", summary_only=True)
        self._emit("\n" + self._stamp("End of computation") + "\n", both=True)

    def writeFile(self, label, *args):
        if not self.writeOut:
            return
        if label == "overlap":
            Smat = np.asarray(args[0])
            cond = np.linalg.cond(Smat)
            self._emit(f"\noverlap condition number {cond:5.3e}"
                       f"\nOVERLAP MATRIX\n{Smat}\n\n")
        elif label == "hamiltonian":
            hmat = convert(args[0], self.eShift, self.convertUnit)
            self._emit(f"HAMILTONIAN MATRIX\n{args[1]}\n{hmat}\n\n")
        elif label == "eigenvalues":
            evalues = convert(args[0], self.eShift, self.convertUnit)
            self._emit(f"Eigenvalues\n{evalues}\n")
        elif label == "iteration":
            st = args[0]
            self._emit("\n\n" + "." * 20 + "\tInfo per iteration\t" + "." * 20 + "\n"
                       f"Lanczos iteration: {st['outerIter']}"
                       f"\tKrylov iteration: {st['innerIter']}"
                       f"\tCumulative Krylov iteration: {st['cumIter']}\n")
        elif label == "KSmaxD":
            self._emit("Maximum bond dimensions of Krylov vectors"
                       f"{args[0]['KSmaxD']}\n\n")
        elif label == "fitmaxD":
            self._emit("Maximum bond dimensions of fitted vectors"
                       f"{args[0]['fitmaxD']}\n\n")
        elif label == "results":
            energies = convert(args[0], self.eShift, self.convertUnit)
            target = convert(self.sigma, self.eShift, self.convertUnit)
            # warns when the final subspace carries a (near-)degenerate
            # cluster around the target — nearest-pick results are then
            # selection-order sensitive (reference: util_funcs.py:133-144,
            # defined there but never wired in)
            ev_nearest = nearest_degenerate(energies, target)[1]
            self._emit("\n\n" + "-" * 20 + "\tFINAL RESULTS\t" + "-" * 20 + "\n"
                       "All subspace eigenvalues:\n"
                       f"{energies}\n"
                       f"Target, Lanczos (nearest) {target}, {ev_nearest}\n")
        elif label == "summary":
            status = args[1]
            target = convert(self.sigma, self.eShift, self.convertUnit)
            excitation = convert(convert(args[0], unit=self.convertUnit),
                                 eShift=self.eShift)
            lines = "{:>4} {:>6} {:>6} {:>12}".format(
                status["outerIter"], status["innerIter"], status["cumIter"],
                f"{target:5.2f}")
            for iBlock in range(status["nBlock"]):
                lines += "{:>18}".format(f"{excitation[iBlock]:.10f}")
            lines += "{:>16} {:>16}".format(f"{status['residual']:5.4e}",
                                            f"{status['runTime']:.2f}\n")
            self._emit(lines, summary_only=True)


class FeastReporter(_ReporterBase):
    """Reporter for the FEAST driver
    (parity: reference printUtils.py:279-500, class FeastPrintUtils)."""

    def __init__(self, guessVector, nc, quad, rmin, rmax, eConv, maxit,
                 writeOut, eShift, convertUnit, status,
                 outFileName=None, summaryFileName=None):
        super().__init__(writeOut,
                         outFileName or "iterations_feast.out",
                         summaryFileName or "summary_feast.out")
        self.subspace = len(guessVector)
        self.options = guessVector[0].options
        self.nc = nc
        self.quad = quad
        self.rmin = rmin
        self.rmax = rmax
        self.eConv = eConv
        self.maxit = maxit
        self.eShift = eShift
        self.convertUnit = convertUnit
        self.status = status

    def fileHeader(self):
        if not self.writeOut:
            return
        self._emit("startingPoint\n", summary_only=True)
        lines = self._stamp("Starting computation")
        formatStyle = "{:12} {:>14} :: {:20}"
        lines += formatStyle.format("m0", self.subspace, "Subspace dimensions") + "\n"
        lines += formatStyle.format("nc", self.nc, "Number of quadrature points") + "\n"
        lines += formatStyle.format("quad", self.quad, "Quadrature distribution") + "\n"
        lines += formatStyle.format("emin", convert(self.rmin, self.eShift, self.convertUnit),
                                    "Minimum target excitation energy") + "\n"
        lines += formatStyle.format("emax", convert(self.rmax, self.eShift, self.convertUnit),
                                    "Maximum target excitation energy") + "\n"
        lines += formatStyle.format("econv", f"{self.eConv:.03g}", "Eigenvalue convergence") + "\n"
        lines += formatStyle.format("maxit", self.maxit, "Maximum FEAST iterations") + "\n"
        lines += formatStyle.format("eShift", self.eShift, "shift energy") + "\n"
        lines += formatStyle.format("convertUnit", self.convertUnit, "convertUnit") + "\n"
        lines += self._solver_settings_block(self.options, formatStyle)
        lines += formatStyle.format("Phase", self.status["phase"],
                                    "Stage of phase calculation") + "\n\n"
        self._emit(lines, both=True)

        header = "{:>4} {:>6}".format("it", "quad")
        for iSubspace in range(self.subspace):
            header += "{:>16}".format("Evalue" + str(iSubspace + 1))
        header += "{:>16} {:>16}".format("residual", "time(seconds)\n")
        self._emit(header, summary_only=True)

    def fileFooter(self):
        if not self.writeOut:
            return
        self._emit("endingPoint\n", summary_only=True)
        self._emit("\n" + self._stamp("End of computation") + "\n", both=True)

    def writeFile(self, label, *args):
        if not self.writeOut:
            return
        if label == "overlap":
            self._emit(f"OVERLAP MATRIX\n{np.asarray(args[0])}\n\n")
        elif label == "hamiltonian":
            hmat = convert(args[0], self.eShift, self.convertUnit)
            self._emit(f"HAMILTONIAN MATRIX\n{hmat}\n\n")
        elif label == "eigenvalues":
            evalues = convert(args[0], self.eShift, self.convertUnit)
            self._emit(f"Eigenvalues\n{evalues}\n")
        elif label == "iteration":
            self._emit("\n\n" + "." * 20 + "\tInfo per iteration\t" + "." * 20 + "\n"
                       f"FEAST iteration: {args[0]['outerIter']}\n")
        elif label == "summary":
            status = args[2]
            excitation = convert(convert(args[0], unit=self.convertUnit),
                                 eShift=self.eShift)
            residual = args[1]
            lines = "{:>4} {:>6}".format(status["outerIter"], status["quadrature"])
            for e in excitation:
                lines += "{:>16}".format(f"{e:.08f}")
            lines += "{:>16} {:>16}".format(f"{residual:5.4e}",
                                            f"{status['runTime']:.2f}\n")
            self._emit(lines, summary_only=True)
        elif label == "results":
            energies = convert(args[0], self.eShift, self.convertUnit)
            self._emit("\n\n" + "-" * 20 + "\tFINAL RESULTS\t" + "-" * 20 + "\n"
                       "All subspace eigenvalues:\n"
                       f"{energies}\n")
