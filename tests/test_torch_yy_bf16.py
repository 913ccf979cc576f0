"""bf16 Yinyang equals the port's Lloyd (fp16 input, bf16 storage).

B2 (``ops.assign_kernels.assign_only_pass``) picks its top 2 by scores
against the centroids rounded to bf16 and rescores them exactly, so the
Yinyang filter may drop a row only when both the bf16-scored and the exact
distances keep it.  The bf16 panel's error is absolute in score space
(about 2^-7 |x| |c| for L2), far above a margin relative to the distance
where d^2 is small against |x| |c|; these runs hold the loop to Lloyd
there.

The 13K blob mixture of tests/test_yinyang.py as fp16 input, k = 50,
tolerance 0.002, from the port's k-means++ seed-4 start and from four
imported starts (rows drawn with ``RandomState(s)``, s = 2..5): Yinyang
gives Lloyd's iteration lines, assignments and centroids bitwise, and
the port's Lloyd gives ``kmeans_tpu``'s iteration lines and assignments
from the imported starts.  The same holds for bf16 cosine on unit blob
rows.  With the wall-clock controller on (its timing picks the path),
two runs agree with each other and with Lloyd bitwise.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kmcuda_tpu import kmeans_tpu
from kmcuda_torch import config, kmeans_cuda

torch.set_num_threads(2)

#: the wall-clock controller's settings, read before any test pins them
CONTROLLER = {"YY_MIN_REMAINING": config.YY_MIN_REMAINING,
              "YY_BAILOUT_MARGIN": config.YY_BAILOUT_MARGIN,
              "YY_LLOYD_HANDOVER": config.YY_LLOYD_HANDOVER}

KW = dict(tolerance=0.002, verbosity=2)


@pytest.fixture(autouse=True)
def pinned_controller(monkeypatch):
    """Never gate, never revoke, never hand over, as
    tests/test_torch_yinyang.py pins it; the controller test sets the
    values back."""
    monkeypatch.setattr(config, "YY_MIN_REMAINING", 0)
    monkeypatch.setattr(config, "YY_BAILOUT_MARGIN", float("inf"))
    monkeypatch.setattr(config, "YY_LLOYD_HANDOVER", False)


@pytest.fixture(scope="module")
def blobs():
    """The 13K blob mixture of tests/test_yinyang.py, fp32."""
    rng = np.random.RandomState(0)
    arr = np.empty((13000, 2), dtype=np.float32)
    arr[:2000] = rng.rand(2000, 2) + [0, 0.5]
    arr[2000:4000] = rng.rand(2000, 2) + [0, 1.5]
    arr[4000:6000] = rng.rand(2000, 2) - [0, 0.5]
    arr[6000:8000] = rng.rand(2000, 2) + [0.5, 0]
    arr[8000:10000] = rng.rand(2000, 2) - [0.5, 0]
    arr[10000:] = rng.rand(3000, 2) * 5 - [2, 2]
    return arr


def _imported(x, s):
    return x[np.random.RandomState(s).choice(len(x), 50, replace=False)]


def _run(x, k, **kw):
    """kmeans_cuda at verbosity 2: (centroids, assignments, iteration
    lines, whole log)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        c, a = kmeans_cuda(torch.from_numpy(x), k, **kw)
    log = buf.getvalue()
    return c, a, [l for l in log.splitlines() if l.startswith("iteration")], \
        log


def _assert_bitwise(got, want):
    assert got[2] == want[2] and len(got[2]) > 0
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    assert torch.equal(torch.nan_to_num(got[0]), torch.nan_to_num(want[0]))


def _entered(log):
    return log.count("passed the global filter")


@pytest.mark.parametrize("start", ["kmeans++ 4", "import 2", "import 3",
                                   "import 4", "import 5"])
def test_fp16_yinyang_equals_lloyd_13k(blobs, start):
    x16 = blobs.astype(np.float16)
    if start.startswith("kmeans++"):
        init = dict(init="kmeans++", seed=int(start.split()[1]))
    else:
        init = dict(init=_imported(blobs, int(start.split()[1])))
    ll = _run(x16, 50, yinyang_t=0, **init, **KW)
    yy = _run(x16, 50, yinyang_t=0.1, **init, **KW)
    assert _entered(yy[3]) > 10 and _entered(ll[3]) == 0
    _assert_bitwise(yy, ll)
    if "init" in init and not isinstance(init["init"], str):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _c, want_a = kmeans_tpu(x16, 50, init=init["init"], device=1,
                                    yinyang_t=0, **KW)
        want = [l for l in buf.getvalue().splitlines()
                if l.startswith("iteration")]
        assert ll[2] == want
        np.testing.assert_array_equal(ll[1].numpy(),
                                      want_a.astype(np.int32))


@pytest.fixture(scope="module")
def unit_blobs():
    """13,000 unit rows around 40 directions at angle ~0.01 as fp16; the
    three rows the cosine check probes are exact unit vectors."""
    rng = np.random.RandomState(1)
    centers = rng.randn(40, 64)
    x = centers[rng.randint(0, 40, 13000)] + 0.01 * rng.randn(13000, 64)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[[0, 6500, 12999]] = np.eye(64)[:3]
    return x.astype(np.float16)


@pytest.mark.parametrize("s", [2, 3])
def test_fp16_cosine_yinyang_equals_lloyd(unit_blobs, s):
    init = _imported(unit_blobs, s)
    kw = dict(metric="cos", init=init, **KW)
    ll = _run(unit_blobs, 50, yinyang_t=0, **kw)
    yy = _run(unit_blobs, 50, yinyang_t=0.1, **kw)
    assert _entered(yy[3]) > 0
    _assert_bitwise(yy, ll)


def test_fp16_yinyang_repeats_with_the_controller_on(blobs, monkeypatch):
    """The wall-clock controller times the loop's windows, so the path a
    run takes depends on the host's load; the result must not."""
    for name, value in CONTROLLER.items():
        monkeypatch.setattr(config, name, value)
    x16 = blobs.astype(np.float16)
    kw = dict(init=_imported(blobs, 2), **KW)
    ll = _run(x16, 50, yinyang_t=0, **kw)
    runs = [_run(x16, 50, yinyang_t=0.1, **kw) for _ in range(2)]
    assert _entered(runs[0][3]) > 0
    _assert_bitwise(runs[1], runs[0])
    _assert_bitwise(runs[0], ll)
