"""The kNN walk kernel (B3) against its plain-torch twin, on the card.

Every test here needs a CUDA device and skips without one.  On the card:

    python -m pytest --noconftest -q tests/test_torch_knn_kernels.py

Tolerances, as in chip_smoke.py (``knn_kernels.compare_walks``): per-chunk
examined counts equal unless the step where the walks part has its bound
within 1e-5 relative of tau; final neighbour ids (after the shared exact
rescore) equal except where their fp64 distance profiles agree to
rtol 1e-6, or, for bf16 cosine alone, where the two candidate buffers part
only at their kk-th walk distance within the products' rounding
(``knn_kernels.walk_tie``) and the kernel finds at least as many exact
fp64 neighbours there as the twin; distances rtol 1e-6 where the ids are
equal.
"""

import pytest
import torch

from kmcuda_torch.models import knn as TK
from kmcuda_torch.models.problem import prepare
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import knn_kernels as KK
from kmcuda_torch.utils.logging import Logger

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    D.disable_tf32()
    return torch.device("cuda")


def _layout(dev, n, f, kc, dtype, metric, seed):
    """Blob data with two NaN rows, clustered around the blob centers."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    centers = torch.rand(kc, f, generator=g) * 8.0
    which = torch.randint(0, kc, (n,), generator=g)
    x = centers[which] + 0.3 * torch.randn(n, f, generator=g)
    if metric == D.DistanceMetric.COSINE:
        x = x / x.norm(dim=1, keepdim=True)
        centers = centers / centers.norm(dim=1, keepdim=True)
    x[[5, 777]] = float("nan")
    p = prepare(x.to(dev, dtype), kc, metric, dev, Logger(0))
    return TK.plan_pruned(p, centers.to(dev), which.to(dev))


# f = 70 and 251: rows that are not 16-byte aligned (the kernel's plain
# loads), in fp32 and bf16; f = 96: aligned rows (cp.async), three fp32 or
# one and a half bf16 feature chunks; kn = 9 keeps the kk = 25 buffer in
# shared memory, kn = 100 and 200 (kk = 150, 300) in the global scratch;
# kn = 32 (kk = 48) in shared memory for bf16, in the global scratch for
# fp32, whose ring leaves room for kk <= 32
@pytest.mark.parametrize("dtype,metric,kn,f", [
    (torch.float32, D.DistanceMetric.L2, 9, 70),
    (torch.bfloat16, D.DistanceMetric.COSINE, 100, 70),
    (torch.float32, D.DistanceMetric.COSINE, 9, 96),
    (torch.bfloat16, D.DistanceMetric.L2, 9, 96),
    (torch.float32, D.DistanceMetric.L2, 200, 96),
    (torch.bfloat16, D.DistanceMetric.L2, 9, 251),
    (torch.float32, D.DistanceMetric.L2, 9, 251),
    (torch.bfloat16, D.DistanceMetric.L2, 32, 96),
    (torch.float32, D.DistanceMetric.L2, 32, 96),
], ids=["fp32-L2", "bf16-cos", "fp32-cos-f96", "bf16-L2-f96",
        "fp32-L2-kk300", "bf16-L2-f251", "fp32-L2-f251", "bf16-L2-kk48",
        "fp32-L2-kk48"])
def test_walk_kernel_matches_plain(cuda, dtype, metric, kn, f):
    plan = _layout(cuda, 20000, f, 24, dtype, metric, 3)
    assert plan.group > 1
    nchunks = plan.m_total // plan.q_chunk
    args, kw = TK.batch_walk_inputs(plan, 0, nchunks, k_neighbors=kn,
                                    n_clusters=24, metric=metric)
    KK.reset_launch_counts()
    out = KK.compare_walks(args, kw)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["knn_walk"] == 1
    assert out["examined"] > 0
    in_smem = kw["kk"] * kw["chunk"] * 8 <= KK.smem_buffer_bytes(dtype)
    assert in_smem == (kw["kk"] <= (72 if dtype == torch.bfloat16 else 32))
    print("%s f=%d kk=%d, buffer in %s: %d tie rows (%d at the buffers' "
          "edge; exact fp64 neighbours there: kernel %d, plain %d), %d "
          "chunks' examined differ"
          % (dtype, f, kw["kk"], "shared memory" if in_smem
             else "global scratch", out["tie_rows"], out["edge_rows"],
             *out["edge_hits"], out["chunks_differ"]))
