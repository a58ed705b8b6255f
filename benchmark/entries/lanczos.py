"""``inexactLanczosDiagonalization``: one vector, or a block of them with
batched block solves (its default), shift-and-invert about the mix's
sigma, with the mix's ``params`` and ``linear`` (MINRES) options."""

from ..harness.entries import vectors


def solve(op, G, tin, traffic, report):
    from eigensolvers_tpu_torch import inexactLanczosDiagonalization
    vs = vectors(G, traffic, report)
    return inexactLanczosDiagonalization(
        op, vs if len(vs) > 1 else vs[0], tin["sigma"], writeOut=False,
        **traffic["params"])
