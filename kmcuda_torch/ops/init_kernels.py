"""The k-means++ / AFK-MC2 step kernel and its plain-torch twin.

:func:`point_min` is the step of the init loops (``models.
initialization``): the distance of every row to one new centroid, folded
into the running minimum.  It replaces the step XLA fuses in the JAX
package (``kmcuda_tpu/ops/distance.py:point_distances``, its product at
:220, inside the on-device loop of ``kmcuda_tpu/models/
initialization.py:162-167``): x is read once in its storage dtype with
fp32 accumulation, and no (n, f) temporary is made.

On a CUDA tensor the wrapper launches ``kmt_point_min``
(``csrc/init_step.cu``), built at first use (see ``ops._build``).  On a
CPU tensor, and only there, it runs :func:`point_min_reference`, the
composition of ``ops.distance.point_distances``, ``torch.where`` and
``torch.minimum`` the loops ran before, which the CPU tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the
card.  Any other device raises.
"""

import torch

from kmcuda_torch.ops import _build
from kmcuda_torch.ops import distance as D
from kmcuda_torch.utils.errors import KMTPUInvalidArguments

#: kernel launches per entry; the wrapper adds one where it launches
LAUNCHES = {"point_min": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_args(x, x_sq, valid, c, m) -> None:
    for name, t in (("x", x), ("x_sq", x_sq), ("valid", valid), ("c", c),
                    ("m", m)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.device != x.device:
            raise KMTPUInvalidArguments(
                "%s is on %s, x on %s" % (name, t.device, x.device))
        if not t.is_contiguous():
            raise KMTPUInvalidArguments("%s must be contiguous" % name)
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise KMTPUInvalidArguments(
            "x must be (n, f) float32 or bfloat16, got %s %s"
            % (tuple(x.shape), x.dtype))
    n, f = x.shape
    for name, t, dtype, shape in (
            ("x_sq", x_sq, torch.float32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("c", c, torch.float32, (f,)), ("m", m, torch.float32, (n,))):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise KMTPUInvalidArguments(
                "%s must be %s %s, got %s %s" % (name, shape, dtype,
                                                 tuple(t.shape), t.dtype))
    if x.device.type not in ("cpu", "cuda"):
        raise KMTPUInvalidArguments("unsupported device %s" % x.device)


def point_min(x, x_sq, valid, c, m, metric: D.DistanceMetric, *,
              first: bool):
    """One init step, in place: ``m`` becomes ``where(valid, d, 0)`` when
    ``first``, else ``minimum(m, d)``, with d (n,) the distance of each row
    of ``x`` (n, f; fp32 or bf16) to the fp32 point ``c`` (f,): the
    product takes ``c`` rounded to the storage dtype, |c|^2 the fp32 ``c``.
    ``x_sq`` (n,) fp32, ``valid`` (n,) bool, ``m`` (n,) fp32.  Returns
    ``m``."""
    _check_args(x, x_sq, valid, c, m)
    if x.device.type == "cpu":
        return point_min_reference(x, x_sq, valid, c, m, metric, first=first)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.kmt_point_min(
            x.data_ptr(), x_sq.data_ptr(), valid.data_ptr(), c.data_ptr(),
            m.data_ptr(), x.shape[0], x.shape[1],
            int(x.dtype == torch.bfloat16),
            int(metric == D.DistanceMetric.COSINE), int(first),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "kmt_point_min")
    LAUNCHES["point_min"] += 1
    return m


def point_min_reference(x, x_sq, valid, c, m, metric: D.DistanceMetric, *,
                        first: bool):
    """Plain twin of :func:`point_min`: ``point_distances`` then
    ``torch.where`` (first step) or ``torch.minimum`` into ``m``."""
    d = D.point_distances(x, x_sq, c, metric)
    if first:
        return m.copy_(torch.where(valid, d, 0.0))
    return torch.minimum(m, d, out=m)
