"""``kmt_assign``'s route rule (``ops.assign_kernels.assign_route``) and its
wiring, on the CPU.

The persistent kernel (``csrc/assign.cu``, ``assign_kernel_ws``) keeps a
row tile's x in shared memory, so it takes bf16 rows of 64 to 256 features
that TMA can load: 16-byte aligned rows (f a multiple of 8, an aligned
first row).  Everything else takes the streamed kernel.  The wrapper is
driven here with a stand-in library that records the arguments it is
given; on the card ``tests/test_torch_kernels.py`` holds the two routes
bitwise equal.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmcuda_torch.ops import assign_kernels as K
from kmcuda_torch.ops import distance as D
from kmcuda_torch.utils import profiling as P

BF16, FP32 = torch.bfloat16, torch.float32
S, W = K.ROUTE_STREAMED, K.ROUTE_PERSISTENT


@pytest.mark.parametrize("dtype,f,aligned,route", [
    (BF16, 63, True, S),        # below one 64-feature chunk
    (BF16, 64, True, W),
    (BF16, 200, True, W),
    (BF16, 256, True, W),
    (BF16, 257, True, S),       # past the resident tile
    (BF16, 252, True, S),       # f % 8 != 0: rows not 16-byte aligned
    (BF16, 70, True, S),
    (BF16, 3, True, S),
    (BF16, 256, False, S),      # unaligned first row
    (FP32, 256, True, S),       # 3xTF32 keeps the streamed kernel
    (FP32, 64, True, S),
], ids=lambda v: str(v).replace("torch.", ""))
def test_assign_route_at_its_edges(dtype, f, aligned, route):
    assert K.assign_route(dtype, f, aligned) == route


class _Recorder:
    """Stands in for the kernel library: records ``kmt_assign``'s
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def kmt_assign(self, *args):
        self.calls.append(args)
        return 0


def _inputs(n, f, k, dtype, offset=0):
    g = torch.Generator().manual_seed(f)
    flat = torch.empty(n * f + offset, dtype=dtype)
    x = flat[offset:].view(n, f)
    x.copy_(torch.rand(n, f, generator=g).to(dtype))
    valid = torch.ones(n, dtype=torch.bool)
    prev = torch.zeros(n, dtype=torch.int32)
    c = torch.rand(k, f, generator=g)
    return x, valid, prev, c


@pytest.mark.parametrize("metric", [D.DistanceMetric.L2,
                                    D.DistanceMetric.COSINE],
                         ids=["L2", "cos"])
@pytest.mark.parametrize("dtype,f,offset,route", [
    (BF16, 256, 0, W), (BF16, 64, 0, W), (BF16, 63, 0, S),
    (BF16, 256, 1, S), (FP32, 256, 0, S)],
    ids=["bf16-256", "bf16-64", "bf16-63", "bf16-256-unaligned",
         "fp32-256"])
def test_the_wrapper_passes_the_route(metric, dtype, f, offset, route):
    """``_launch_assign`` passes the route of the input it sees, whatever
    the metric, counts a persistent launch in ``LAUNCHES`` only on that
    route, and takes a forced route as given."""
    x, valid, prev, c = _inputs(5, f, 3, dtype, offset)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    lib = _Recorder()
    before = K.LAUNCHES["assign_persistent"]
    K._launch_assign(lib, x, valid, prev, c, 3, metric, None)
    *_, is_bf16, cosine, got, stream = lib.calls[0]
    assert (got, is_bf16, stream) == (route, int(dtype == BF16), None)
    assert cosine == int(metric == D.DistanceMetric.COSINE)
    assert K.LAUNCHES["assign_persistent"] - before == int(route == W)
    K._launch_assign(lib, x, valid, prev, c, 3, metric, None, route=S)
    assert lib.calls[1][-2] == S


def test_persistent_launches_are_counted_in_the_record():
    """``assign.persistent`` joins the traced call's record once per
    launch that took the persistent route, and only under a session."""
    x, valid, prev, c = _inputs(5, 128, 3, BF16)
    lib = _Recorder()

    def call():
        for _ in range(2):
            K._launch_assign(lib, x, valid, prev, c, 3, D.DistanceMetric.L2,
                             None)
        K._launch_assign(lib, x.float(), valid, prev, c, 3,
                         D.DistanceMetric.L2, None)

    traced = P.public_call("kmeans")(call)
    with profile(activities=[ProfilerActivity.CPU]):
        traced()
    counters = P.records()[-1]["counters"]
    assert counters == [["assign.persistent", 1], ["assign.persistent", 1]]
    before = P.records()
    traced()
    assert P.records() == before
