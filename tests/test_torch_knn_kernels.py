"""The kNN walk kernel (B3) against its plain-torch twin, on the card.

Every test here needs a CUDA device and skips without one.  On the card:

    python -m pytest --noconftest -q tests/test_torch_knn_kernels.py

Tolerances, as in chip_smoke.py (``knn_kernels.compare_walks``): per-chunk
examined counts equal unless the step where the walks part has its bound
within 1e-5 relative of tau; final neighbour ids (after the shared exact
rescore) equal except where their fp64 distance profiles agree to
rtol 1e-6; distances rtol 1e-6 where the ids are equal.
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


@pytest.mark.parametrize("dtype,metric,kn", [
    (torch.float32, D.DistanceMetric.L2, 9),
    (torch.bfloat16, D.DistanceMetric.COSINE, 100),
], ids=["fp32-L2", "bf16-cos"])
def test_walk_kernel_matches_plain(cuda, dtype, metric, kn):
    plan = _layout(cuda, 20000, 70, 24, dtype, metric, 3)
    assert plan.group > 1
    nchunks = plan.m_total // plan.q_chunk
    args, kw = TK.batch_walk_inputs(plan, 0, nchunks, k_neighbors=kn,
                                    n_clusters=24, metric=metric)
    KK.reset_launch_counts()
    out = KK.compare_walks(args, kw)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["knn_walk"] == 1
    assert out["examined"] > 0
