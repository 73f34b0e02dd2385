"""Milliseconds of ``compute_cov_mmd_1nna`` a round: the three pairwise
Chamfer matrices (K1 launches, each matrix ending in a copy to the host)
and COV, MMD and 1-NNA on the host, averaged over the window's rounds."""


def read(ctx):
    spans = ctx.get("pairwise_cd_s")
    return sum(spans) / len(spans) * 1e3 if spans else None
