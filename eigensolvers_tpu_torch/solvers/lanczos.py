"""Inexact shift-and-invert (block) Lanczos eigensolver.

Algorithm parity with the reference (reference: inexact_Lanczos.py:229-443;
Huang & Carrington JCP 112, 8765 (2000); Rano & Larsson arXiv:2506.22574):
block Krylov space built with the spectral transform F(H) = (sigma - H)^{-1},
each application being an approximate iterative solve; Löwdin-orthogonal
projected diagonalization; pick-function state selection; restarts from Ritz
vectors; linear-dependence and futile-restart failure handling.  Numerical
contract constants: zero-vector threshold ``0.001*eConv``
(reference: inexact_Lanczos.py:100), lindep threshold 1e-14, futile-restart
limit 3 with improvement threshold ``max(1e-9, eConv)``
(reference: inexact_Lanczos.py:167-194).

Device restructurings (not semantics changes):
  * the nBlock solves of one Krylov step run as ONE batched device
    computation when the backend provides ``solveBatch``
    (reference loops them, inexact_Lanczos.py:319-325);
  * subspace assembly is matmul-based inside the backend;
  * checkpointing is backend-neutral and opt-in (the reference's
    ``saveTNSsEachIteration=True`` default crashes its own dense backend,
    reference: inexact_Lanczos.py:384-393 — documented quirk, not replicated).
"""

from __future__ import annotations

import time
import warnings
from typing import List, Union

import numpy as np
import scipy.linalg as sla

from ..vectors.abstract import AbstractVector
from ..utils.status import lanczos_status
from ..utils.subspace import (
    basisTransformation,
    diagonalizeHamiltonian,
    eigenvalueResidual,
    get_pick_function_close_to_sigma,
    lowdinOrthoMatrix,
)
from ..utils.reporting import LanczosReporter
from ..utils import checkpointing
from ..utils.profiling import PhaseTimer, spans


# ---------------------------------------------------------------------------
# helpers (separable for testing, mirroring reference decomposition)
# ---------------------------------------------------------------------------
def generateSubspace(Hop, vec, sigma, eConv):
    """One Krylov step: solve (sigma - H) x = vec, normalize if nonzero.
    Nonzero means norm > 0.001*eConv (reference: inexact_Lanczos.py:84-105).

    :returns: (new vector, nonzero flag)
    """
    typeClass = type(vec)
    out = typeClass.solve(Hop, vec, sigma)
    if typeClass.norm(out) > 0.001 * eConv:
        return typeClass.normalize(out), True
    return out, False


def generateSubspaceBlock(Hop, vecs: List, sigma, eConv):
    """Batched Krylov step for nBlock vectors: one device computation for all
    shifted solves (batched replacement for the reference's per-block loop,
    inexact_Lanczos.py:319-325).

    :returns: (list of new vectors, nonzero flag)  — mirrors the reference's
        all-or-nothing semantics: any zero solution aborts the step.
    """
    typeClass = type(vecs[0])
    outs = typeClass.solveBatch(Hop, vecs, [sigma] * len(vecs))
    newVectors = []
    for out in outs:
        if typeClass.norm(out) > 0.001 * eConv:
            newVectors.append(typeClass.normalize(out))
        else:
            return [out], False
    return newVectors, True


def _convergence(value, ref):
    """Relative eigenvalue error (reference: inexact_Lanczos.py:107-112)."""
    return abs(value - ref) / max(abs(value), 1e-14)


def checkConvergence(ev, eConv, status, printObj=None):
    """Convergence check on the nBlock tracked eigenvalues vs the previous
    iteration; maintains the 2-deep ``ref`` history
    (reference: inexact_Lanczos.py:115-143)."""
    isConverged = False
    nBlock = status["nBlock"]
    # sort to avoid root flipping (reference: inexact_Lanczos.py:127)
    nBlockEigenvalues = np.sort(np.asarray(ev)[0:nBlock])

    if status["cumIter"] > 1:
        reference = status["ref"][-1]
        residual = eigenvalueResidual(nBlockEigenvalues, reference)
        status["residual"] = residual
        if residual <= eConv:
            isConverged = True

    status["isConverged"] = isConverged
    status["runTime"] = time.time() - status["startTime"]
    if printObj is not None:
        printObj.writeFile("summary", nBlockEigenvalues, status)
    status["ref"].append(nBlockEigenvalues)
    if len(status["ref"]) > 2:
        status["ref"].pop(0)
    return status


def checkFitting(evNew, ev, checkFitTol, status):
    """Validate the energy of a fitted linear combination against the energy
    before fitting; only meaningful for inexact-addition backends
    (reference: inexact_Lanczos.py:145-165 — defined there but never called;
    here it is wired into the finish-up path for compressed backends)."""
    if status["flagAddition"]:
        return True
    if _convergence(evNew, ev) > checkFitTol:
        warnings.warn(
            f"Linear combination inaccurate for block {status['iBlock']}: "
            f"after fit {evNew}, before fit {ev}")
        return False
    return True


def terminateRestart(blockEnergies, eConv, status, num=3):
    """Count futile restarts under linear dependence; terminate after ``num``
    restarts without residual improvement beyond max(1e-9, eConv)
    (reference: inexact_Lanczos.py:167-194)."""
    decision = False
    prevBlockEnergies = status["ref"][0]
    if status["lindep"]:
        residual = eigenvalueResidual(blockEnergies, prevBlockEnergies)
        if residual > max(1e-9, eConv):
            status["futileRestarts"] += 1
    if status["futileRestarts"] > num:
        warnings.warn("Lindep and did not have fruitful restarts")
        decision = True
    return decision


def analyzeStatus(status, maxit, L):
    """Single continue/stop decision from the status dict
    (reference: inexact_Lanczos.py:197-222)."""
    continueIteration = True
    if status["isConverged"]:
        continueIteration = False
    if status["outerIter"] == maxit - 1 and status["innerIter"] == L - 1:
        if not status["isConverged"]:
            warnings.warn("Lanczos iterations not converged at maxit")
            continueIteration = False
    return continueIteration


# ---------------------------------------------------------------------------
# main driver
# ---------------------------------------------------------------------------
def inexactLanczosDiagonalization(
        H, v0: Union[AbstractVector, List[AbstractVector]],
        sigma, L, maxit, eConv, checkFitTol=1e-7,
        Hsolve=None,
        pick=None, status=None,
        writeOut=True, eShift=0.0, convertUnit="au",
        outFileName=None, summaryFileName=None,
        saveEachIteration=False, saveDir="saveKrylov",
        batchBlockSolves=True, thickRestart=True):
    """Compute eigenpairs near ``sigma`` with inexact shift-and-invert
    (block) Lanczos.

    Input parameters (parity: reference inexact_Lanczos.py:229-276)
    ----------------------------------------------------------------
    H : operator (matrix / AbstractOperator / SoP) — must be Hermitian
    v0 : guess vector, or list of mutually orthogonal guesses (block Lanczos:
         one Krylov chain per guess)
    sigma : eigenvalue target (shift)
    L : Krylov space dimension per restart
    maxit : maximum Lanczos (restart) iterations
    eConv : relative eigenvalue convergence tolerance
    checkFitTol : tolerance for validating fitted vectors
    Hsolve : operator used for Krylov generation only (default: H)
    pick : state-selection function (default: closest to sigma)
    status : optional dict merged over the status defaults
    writeOut, eShift, convertUnit, outFileName, summaryFileName : reporting
    saveEachIteration : opt-in backend-neutral checkpoint of the Krylov basis
        per cumulative iteration (reference equivalent:
        ``saveTNSsEachIteration``, TTNS-only there)
    saveDir : checkpoint directory
    batchBlockSolves : run the nBlock solves of one step as a single batched
        device computation (batched fast path; set False to force the reference's
        sequential order)
    thickRestart : restart with the nBlock tracked Ritz vectors PLUS extra
        retained Ritz columns and the residual-carrying last basis vector
        (True = max(2, nBlock) extras; an int sets the extra count; 0/False
        = the reference's nBlock-only restart, inexact_Lanczos.py:415-438)

    Returns
    -------
    (ev, Ylist, status): eigenvalues (np.ndarray), eigenvectors (list of
    backend vectors), status dict.
    """
    if isinstance(v0, AbstractVector):
        v0 = [v0]
    else:
        assert isinstance(v0, (list, tuple)), f"{type(v0)=}"
        v0 = list(v0)
    if Hsolve is None:
        Hsolve = H
    typeClass = type(v0[0])
    nBlock = len(v0)

    Ylist = list(v0)
    Smat = typeClass.overlapMatrix(Ylist)
    if not np.allclose(Smat, np.eye(nBlock), rtol=1e-3, atol=1e-3):
        if nBlock > 1:
            # GS-orthogonalizing here would silently change the block space
            # (reference: inexact_Lanczos.py:288-295)
            raise RuntimeError(f"Input vectors not orthogonalized: {Smat=}")
        Ylist[0].normalize()
        Smat = np.array([[1.0]], dtype=Smat.dtype)
    Hmat = typeClass.matrixRepresentation(H, Ylist)

    status = lanczos_status(status, Ylist[0], nBlock)
    if pick is None:
        pick = get_pick_function_close_to_sigma(sigma)
    assert callable(pick)

    printObj = LanczosReporter(
        Ylist[0], sigma, L, maxit, eConv, checkFitTol,
        status.get("writeOut", writeOut), eShift, convertUnit, pick, status,
        outFileName, summaryFileName)
    printObj.fileHeader()

    # Defensive initialization (the reference can hit NameErrors when the very
    # first step degenerates — SURVEY.md §7 quirk list, inexact_Lanczos.py:358,:440)
    ev = np.full(len(Ylist), np.nan)
    uSH = None
    degenerateInput = False
    lindepProblem = False
    continueIteration = True
    justRestartedThick = False
    timer = PhaseTimer("es.lanczos", getattr(Ylist[0], "device", None))

    for outerIter in spans("es.lanczos.outer", range(maxit)):
        status["outerIter"] = outerIter
        status["KSmaxD"] = [Ylist[0].maxD]
        status["fitmaxD"] = None
        # Y0 is the first basis vector
        for innerIter in spans("es.lanczos.step", range(1, L)):
            status["innerIter"] = innerIter
            status["cumIter"] += 1
            #
            # Generate subspace: nBlock inexact shifted solves
            #
            seeds = [Ylist[-iBlock] for iBlock in range(1, nBlock + 1)]
            with timer.phase("solve"):
                if batchBlockSolves and nBlock > 1:
                    newVectors, nonzero = generateSubspaceBlock(
                        Hsolve, seeds, sigma, eConv)
                else:
                    newVectors = []
                    nonzero = True
                    for seed in seeds:
                        out, nonzero = generateSubspace(Hsolve, seed, sigma, eConv)
                        if not nonzero:
                            newVectors = [out]
                            break
                        newVectors.append(out)
            if not nonzero:
                status["zeroVector"] = True
                warnings.warn(
                    f"Alert: zero vector: ||inv(H-sigma)vec||="
                    f"{typeClass.norm(newVectors[0]):5.3e}")
                break
            #
            # Orthogonalize (also against each other) and extend S/H
            #
            lindepProblem = False
            for iBlock in range(nBlock):
                status["iBlock"] = iBlock
                with timer.phase("orthogonalize"):
                    newOrthVec = typeClass.orthogonalize_against_set(
                        newVectors[iBlock], Ylist)
                if newOrthVec is None:
                    lindepProblem = True
                    status["lindep"] = True
                    if printObj.writeOut:
                        warnings.warn(
                            f"Linear dependency problem in iteration {outerIter} "
                            f"and microiteration {innerIter} for block state "
                            f"{iBlock}, abort current Lanczos iteration and restart.")
                    break
                Ylist.append(newOrthVec.compress())
                status["KSmaxD"].append(Ylist[-1].maxD)
                with timer.phase("extend_subspace"):
                    Smat = typeClass.extendOverlapMatrix(Ylist, Smat)
                    Hmat = typeClass.extendMatrixRepresentation(H, Ylist, Hmat)

            printObj.writeFile("iteration", status)
            printObj.writeFile("overlap", Smat)
            printObj.writeFile("KSmaxD", status)
            if lindepProblem:
                if uSH is None:
                    # Degenerate input: linear dependence on the very first
                    # Krylov step means the guess already spans the target
                    # space to the solver's resolution (e.g. an exact
                    # eigenvector as guess).  Return the guesses'
                    # Rayleigh-Ritz values instead of the reference's nan
                    # (which there follows a NameError risk,
                    # inexact_Lanczos.py:358).
                    status, uS0 = lowdinOrthoMatrix(Smat, status)
                    status["lindep"] = True
                    ev, uv0 = diagonalizeHamiltonian(uS0, Hmat, printObj)
                    uSH = uS0 @ uv0
                    degenerateInput = True
                break
            #
            # Diagonalize in Löwdin-orthogonalized basis.  Gram-Schmidt above
            # usually catches dependence first; if Löwdin still flags it
            # (loss of orthogonality under severe cancellation), proceed with
            # the reduced independent subspace — canonical orthogonalization
            # already dropped the dependent directions.  (The reference
            # asserts here instead, inexact_Lanczos.py:368, which crashes the
            # run; the restart + futile-restart machinery below needs the
            # flagged-but-continuing path to be reachable.)
            #
            with timer.phase("diagonalize"):
                status, uS = lowdinOrthoMatrix(Smat, status)
                if status["lindep"] and printObj.writeOut:
                    warnings.warn(
                        f"Löwdin flagged linear dependence at iteration "
                        f"{outerIter}/{innerIter}; continuing with "
                        f"{uS.shape[1]} of {uS.shape[0]} directions")
                ev, uv = diagonalizeHamiltonian(uS, Hmat, printObj)
                uSH = uS @ uv
                del uv
                idx = pick(uSH, Ylist, ev)
                assert len(idx) == len(ev), f"{len(ev)=} {len(idx)=}"
                ev = ev[idx]
                uSH = uSH[:, idx]
            #
            # Convergence / continuation checks
            #
            status = checkConvergence(ev, eConv, status, printObj)
            if justRestartedThick and status["isConverged"]:
                # A thick restart RETAINS the tracked Ritz vector in the
                # restarted subspace, so the first post-restart residual is
                # artificially tiny (the value barely moves by
                # construction, not because it converged).  Require the
                # next genuine iteration to confirm.  The reference's
                # nBlock-only restart does not need this: discarding the
                # subspace makes its post-restart values move.
                status["isConverged"] = False
            justRestartedThick = False
            continueIteration = analyzeStatus(status, maxit, L)

            if saveEachIteration:
                # per-iteration snapshots ride the native async writer when
                # available (non-blocking; flushed before the final return)
                checkpointing.save_checkpoint(
                    saveDir, status["cumIter"], Ylist, status,
                    eigencoefficients=uSH, eigenvalues=ev,
                    async_writer=checkpointing.default_async_writer())

            if not continueIteration:
                break
        if lindepProblem:
            if degenerateInput:
                # Degenerate first step: Rayleigh-Ritz of the guesses was
                # computed above; nothing to restart from.
                break
            # Abort the current Lanczos iteration and restart from the
            # current Ritz vectors (SURVEY §5 failure handling; the
            # futile-restart counter below bounds fruitless restarts).
            # Basis vectors appended after the last diagonalization have no
            # Ritz coefficients yet — drop them before the transformation.
            Ylist = Ylist[:uSH.shape[0]]
        elif status["zeroVector"] and uSH is None:
            # Zero vector before any diagonalization: no Ritz data exists
            # (reference NameError risk, inexact_Lanczos.py:440) — return
            # the defensive initialization.
            break

        if not continueIteration and not lindepProblem:
            # Finish up: fit the Ritz vectors and validate orthonormality.
            # For compressed backends a fixed fit bond budget can lose
            # norm/orthogonality (S diag < 1 by percent); instead of only
            # warning (the reference's behavior, inexact_Lanczos.py:404-412),
            # escalate the stateFittingArgs bond budget and refit until S
            # passes checkFitTol or the budget is exhausted (the reference's
            # own production config fits at maxD = L*MAX_D for the same
            # reason, examples/ttns2_ch3cn.py:37).
            evBefore = ev.copy()
            Yfit = basisTransformation(Ylist, uSH)
            Smat = typeClass.overlapMatrix(Yfit)
            fitOk = np.allclose(Smat, np.eye(len(Yfit)),
                                rtol=checkFitTol, atol=checkFitTol)
            opts = getattr(Ylist[0], "options", None)
            if not fitOk and isinstance(opts, dict) and "compressArgs" in opts:
                base = opts.get("stateFittingArgs", opts["compressArgs"])
                if isinstance(base, dict) and base.get("maxD"):
                    saved = opts.get("stateFittingArgs")
                    try:
                        for bump in (2, 4):
                            opts["stateFittingArgs"] = dict(
                                base, maxD=int(base["maxD"]) * bump)
                            Yfit = basisTransformation(Ylist, uSH)
                            Smat = typeClass.overlapMatrix(Yfit)
                            fitOk = np.allclose(
                                Smat, np.eye(len(Yfit)),
                                rtol=checkFitTol, atol=checkFitTol)
                            if fitOk:
                                status["fitEscalation"] = bump
                                break
                    finally:
                        if saved is None:
                            opts.pop("stateFittingArgs", None)
                        else:
                            opts["stateFittingArgs"] = saved
            Ylist = Yfit
            if not fitOk:
                warnings.warn(
                    f"Alert: final eigenvectors are not properly fitted. S=\n{Smat}")
            if not status["flagAddition"]:
                # fit-quality validation for compressed backends: only the
                # nBlock tracked diagonal entries are needed (the full
                # m x m representation at fit bond is the most expensive
                # contraction of the whole run), and each is evaluated as
                # a Rayleigh quotient on a compressArgs-compressed COPY of
                # the fitted vector — the uncompressed sandwich applies
                # the operator at the (large) fit bond, materializing
                # (fitD * opBond)^3 internal tensors on trees (measured:
                # tens of GB at fit bond ~50), while compression at the
                # Krylov bond perturbs the energy only at second order in
                # the truncation error (<< checkFitTol)
                for iBlock in range(min(status["nBlock"], len(Ylist))):
                    status["iBlock"] = iBlock
                    vchk = Ylist[iBlock].compress()
                    eFit = typeClass.matrixRepresentation(H, [vchk])[0, 0]
                    nchk = np.real(typeClass.overlapMatrix([vchk])[0, 0])
                    checkFitting(np.real(eFit) / max(nchk, 1e-300),
                                 evBefore[iBlock], checkFitTol, status)
            status["fitmaxD"] = [item.maxD for item in Ylist]
            printObj.writeFile("fitmaxD", status)
            break
        else:
            # Restart from the current Ritz data.  Thick restart (default,
            # an improvement over the reference's nBlock-only restart —
            # its own TODO at inexact_Lanczos.py:392 "could be improved to
            # thick restart"): keep the nBlock tracked Ritz vectors PLUS
            # up to `thickExtra` further Ritz columns and the last Krylov
            # basis vector (which carries the residual coupling of the
            # truncated chain, the TRLan structure — Wu & Simon, SIAM J.
            # Matrix Anal. 22, 602 (2000)).  The retained directions stop
            # each restart from discarding the subspace information whose
            # loss made lindep-regime restarts futile; S/H are recomputed
            # exactly on the kept set, so no tridiagonal bookkeeping is
            # needed.  The picked nBlock vectors sit LAST so they remain
            # the Krylov seeds (generateSubspace reads Ylist[-iBlock]).
            status["restarts"] += 1
            if thickRestart is True:
                thickExtra = max(2, nBlock)
            else:
                thickExtra = int(thickRestart)
            k = min(nBlock + thickExtra, uSH.shape[1])
            newGuessList = []
            for j in list(range(nBlock, k)) + list(range(nBlock)):
                guess = basisTransformation(Ylist, uSH[:, j])
                # restart guesses are Krylov seeds: bring them back to the
                # Krylov (compressArgs) bond after the high-budget fit —
                # the S/H recomputation below applies the operator to
                # them, which at the FIT bond materializes
                # (fitD * opBond)^3 tree intermediates (memory blow-up);
                # fitting exactly then truncating optimally loses less
                # than fitting at the small bond directly
                newGuessList.append(
                    typeClass.normalize(guess[0].compress()))
            # NOTE: TRLan-style residual augmentation (also retaining the
            # newest Krylov vector) was measured and deliberately NOT
            # adopted: its orthogonal remainder's Rayleigh quotient
            # interpolates neighboring eigenvalues and can sit closer to
            # sigma than the tracked root, and the close-to-sigma pick
            # then flips onto that phantom (observed: tracked value
            # jumping 0.22 off a converged 1e-7 state, final error 20x
            # worse).  With S/H recomputed exactly on the kept Ritz set,
            # top-k retention alone already reduces restarts (3 -> 2 on
            # the interior n=400 config) without the tracking hazard.
            Ylist = newGuessList
            Smat = typeClass.overlapMatrix(Ylist)
            Hmat = typeClass.matrixRepresentation(H, Ylist)
            if not np.allclose(Smat, np.eye(len(Ylist)),
                               rtol=checkFitTol, atol=checkFitTol):
                warnings.warn(
                    f"Alert: restart vectors are not properly fitted. S=\n{Smat}")
                break
            evNew = sla.eigvalsh(Hmat, Smat)
            if len(evNew) != len(status["ref"][0]):
                # thick basis: compare the entries nearest the tracked
                # block energies (same matching rule as FEAST's
                # subspace-shrink handling)
                ref0 = np.asarray(status["ref"][0])
                evNew = np.sort(evNew[
                    np.argmin(np.abs(ref0[:, None] - evNew[None, :]),
                              axis=1)])
            if terminateRestart(evNew, eConv, status):
                break
            status["fitmaxD"] = [item.maxD for item in Ylist]
            printObj.writeFile("fitmaxD", status)
            # The restarted basis is the new reference frame: its Ritz
            # coefficients are the identity (needed if linear dependence
            # aborts the next iteration before any diagonalization).
            lindepProblem = False
            justRestartedThick = bool(thickExtra)
            uSH = np.eye(len(Ylist))

    status["timers"] = timer.summary()
    printObj.writeFile("results", ev)
    printObj.fileFooter()
    printObj.close()

    if saveEachIteration:
        w = checkpointing.default_async_writer()
        if w is not None:
            nerr = w.flush()      # checkpoints durable before returning
            if nerr:
                warnings.warn(f"async checkpoint writer: {nerr} failed writes")

    return ev, Ylist, status
