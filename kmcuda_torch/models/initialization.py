"""Centroid initialization: random, k-means++, AFK-MC2, import.

The port of ``kmcuda_tpu.models.initialization``.  Every draw comes from
a CPU ``torch.Generator`` seeded with ``seed``, so CPU and GPU runs draw
the same numbers; they cannot reproduce the JAX package's ``jax.random``
draws, only their distributions.  The uniforms (and AFK-MC2's candidate
ids) are drawn up front and moved to the device once, and the loops over
the k centroids never read a device value back, except for a progress
line.  Over several row shards the distances are computed on their
shards and each draw reads them on the leader, so the draws are those of
one device whenever the shards' distances are.  Each step's distances go
through ``ops.init_kernels.point_min``, one kernel launch per shard on
the card.  The draw is ``ops.init_kernels.weighted_draw``
(``kmt_weighted_draw`` on a card: two launches in a summation order fixed
by n, so a start repeats bitwise; with one shard it also copies the drawn
row into the centroids), and a k-means++ step is three launches; on the
CPU it is the kernel's plain twin, in the same order.

- random: k distinct *valid* rows, uniformly.
- k-means++: each step draws a row with probability proportional to its
  running *distance* (not squared) to the nearest chosen centroid, as the
  reference does; invalid rows weigh 0.
- AFK-MC2: q[i] = d0_i^2 / (2 sum d0^2) + 1/(2 n_valid) from the first
  centroid; each of the k-1 steps runs a Metropolis-Hastings chain over m
  candidates drawn from q, with weight dmin(candidate)^2 / q(candidate).
- import: the caller's centroids.
"""

import enum

import numpy as np
import torch

from kmcuda_torch import config
from kmcuda_torch.ops import distance as D
from kmcuda_torch.ops import init_kernels as IK
from kmcuda_torch.utils import profiling as P
from kmcuda_torch.utils.errors import KMTPUInvalidArguments


class InitMethod(enum.IntEnum):
    """Value-compatible with KMCUDAInitMethod."""

    RANDOM = 0
    PLUS_PLUS = 1
    AFKMC2 = 2
    IMPORT = 3


#: string -> enum map, mirroring the reference's ``init_methods``.
init_methods = {
    "kmeans++": InitMethod.PLUS_PLUS,
    "k-means++": InitMethod.PLUS_PLUS,
    "afkmc2": InitMethod.AFKMC2,
    "afk-mc2": InitMethod.AFKMC2,
    "random": InitMethod.RANDOM,
}


def generator(seed: int) -> torch.Generator:
    """The CPU generator every draw of a call comes from."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return gen


def _imported(problem, imported) -> torch.Tensor:
    """The caller's centroids on the leader, which broadcasts them."""
    if isinstance(imported, torch.Tensor):
        cent = imported.to(device=problem.device, dtype=torch.float32)
    else:
        cent = torch.tensor(np.asarray(imported, dtype=np.float32),
                            device=problem.device)
    if tuple(cent.shape) != (problem.k, problem.features):
        raise KMTPUInvalidArguments(
            "imported centroids must have shape (%d, %d), got %s"
            % (problem.k, problem.features, (tuple(cent.shape),)))
    return cent


def _random(problem, gen) -> torch.Tensor:
    p = problem
    valid = torch.cat([v.cpu() for v in p.valids])
    rows = torch.nonzero(valid).squeeze(1)
    pick = torch.randperm(rows.numel(), generator=gen)[:p.k]
    return p.take(p.xs, rows[pick]).float()


def _inverse_cdf(cum, t):
    """First index whose cumulative weight exceeds ``t``.  ``t`` is held
    below the total, so a row of weight 0 is never drawn while any weight
    is positive (``u * total`` can round up to the total)."""
    t = torch.minimum(t, torch.nextafter(cum[-1:], torch.zeros_like(t)))
    return torch.clamp(torch.searchsorted(cum, t, right=True),
                       max=cum.shape[0] - 1)


def _progress(problem, label: str, done: int, k: int) -> None:
    """One ``label: done / k centroids`` line per INIT_SEGMENT_CENTROIDS
    centroids when k exceeds it, at verbosity >= 1, after the device has
    caught up (the only sync of the loops)."""
    seg = config.INIT_SEGMENT_CENTROIDS
    if problem.logger.verbosity < 1 or k <= seg:
        return
    if (done - 1) % seg and done != k:
        return
    problem.topo.synchronize()
    problem.logger.info("%s: %d / %d centroids" % (label, done, k))


def _row(problem, idx) -> torch.Tensor:
    """(1, F) fp32 copy of sample ``idx`` ((1,) tensor), on the leader,
    with no host sync."""
    return problem.take(problem.xs, idx).float()


def _draw_row(problem, weights, valid, u, out) -> None:
    """Draws a row ~ ``weights`` (over the valid rows when no weight is
    positive: every valid row already chosen, fewer distinct rows than k)
    at the uniform ``u`` (1,) and copies it, as fp32, into ``out`` (1, F),
    with no host sync, through ``weighted_draw``, which copies the row
    itself when one shard holds every row."""
    p = problem
    if len(p.xs) == 1:
        IK.weighted_draw(weights, valid, u, row_source=p.xs[0],
                         out_row=out[0])
        return
    out.copy_(_row(p, IK.weighted_draw(weights, valid, u)))


def _init_plus_plus(problem, gen) -> torch.Tensor:
    """k-means++ over the problem's valid rows; (k, F) fp32 on the
    leader.  Each shard keeps its running minimum distance; the draw runs
    on the leader over one (n,) buffer of them, of which a shard on the
    leader's device holds a view (updated in place) and any other shard a
    copy (refreshed after each update)."""
    p = problem
    k = p.k
    us = torch.rand(k, generator=gen).to(p.device)
    valid = p.topo.gather(p.valids)
    cent = torch.empty((k, p.features), dtype=torch.float32, device=p.device)
    _draw_row(p, valid.float(), valid, us[0:1], cent[0:1])
    weights = torch.empty(p.n, dtype=torch.float32, device=p.device)
    mindists = []
    for s, c in zip(p.shards, p.topo.broadcast(cent[0])):
        # invalid rows start at 0 and the minimum keeps them there
        own = weights[s.start:s.stop]
        m = (own if s.x.device == p.device
             else torch.empty(s.stop - s.start, device=s.x.device))
        IK.point_min(s.x, s.x_sq, s.valid, c, m, p.metric, first=True)
        if m is not own:
            own.copy_(m)
        mindists.append((own, m))
    for i in range(1, k):
        with P.span("kmt.init.step"):
            _draw_row(p, weights, valid, us[i:i + 1], cent[i:i + 1])
            if i + 1 < k:
                for s, (own, m), c in zip(p.shards, mindists,
                                          p.topo.broadcast(cent[i])):
                    IK.point_min(s.x, s.x_sq, s.valid, c, m, p.metric,
                                 first=False)
                    if m is not own:
                        own.copy_(m)
            _progress(p, "kmeans++", i + 1, k)
    return cent


def _host_draws(q, count: int, gen) -> torch.Tensor:
    """``count`` row ids ~ Categorical(q), with replacement, drawn on the
    host by an fp64 inverse CDF (``torch.multinomial`` stops at 2**24
    categories)."""
    cum = torch.cumsum(q.cpu().double(), 0)
    u = torch.rand(count, generator=gen, dtype=torch.float64)
    return _inverse_cdf(cum, u * cum[-1])


def mh_chain(prob, u):
    """The AFK-MC2 Metropolis-Hastings chain over m candidates, without a
    host sync per step.

    The sequential chain holds one candidate; candidate j replaces the
    held candidate a when ``prob[a] == 0 or prob[j] / prob[a] > u[j]``
    (the first is always taken).  ``next[a]`` is the first such j > a, so
    the chain's final candidate is the end of the path 0 -> next[0] -> ...;
    pointer doubling finds it in log2(m) gathers.  Returns the (1,) int64
    position of the final candidate."""
    m = prob.shape[0]
    pos = torch.arange(m, device=prob.device)
    take = ((prob[:, None] == 0) | (prob[None, :] / prob[:, None] > u[None, :])
            ) & (pos[None, :] > pos[:, None])
    nxt = torch.where(take, pos[None, :], m).amin(1)
    jump = torch.where(nxt < m, nxt, pos)
    for _ in range(max(1, (m - 1).bit_length())):
        jump = jump[jump]
    return jump[0:1]


def _init_afkmc2(problem, m: int, gen) -> torch.Tensor:
    """AFK-MC2 over the problem's valid rows; (k, F) fp32 on the leader.
    The first centroid's distances are computed on their shards, q on the
    leader over the gathered ones; each step gathers its m candidates."""
    p = problem
    k = p.k
    valid = p.topo.gather(p.valids)
    validf = valid.float()
    cent = torch.zeros((k, p.features), dtype=torch.float32, device=p.device)
    _draw_row(p, validf, valid, torch.rand(1, generator=gen).to(p.device),
              cent[0:1])
    d0 = p.topo.gather([
        IK.point_min(x, xsq, v, c, torch.empty_like(xsq), p.metric,
                     first=True)
        for x, xsq, v, c in zip(p.xs, p.x_sqs, p.valids,
                                p.topo.broadcast(cent[0]))])
    d0_sq = d0 * d0
    total = torch.clamp(d0_sq.sum(), min=torch.finfo(torch.float32).tiny)
    q = d0_sq / (2.0 * total) + validf * (0.5 / p.n_valid)
    q = q / q.sum()
    ids = _host_draws(q, (k - 1) * m, gen).view(k - 1, m).to(p.device)
    us = torch.rand((k - 1, m), generator=gen).to(p.device)
    slot = torch.arange(k, device=p.device)
    for i in range(1, k):
        with P.span("kmt.init.step"):
            cand_idx = ids[i - 1]
            cand = p.take(p.xs, cand_idx)
            # min distance of each candidate to the i chosen centroids; the
            # penalty masks the unfilled rows of the buffer
            pen = torch.where(slot < i, 0.0, config.PAD_PENALTY)
            s = D.scores(cand, cent.to(p.dtype).T, D.row_sq_norms(cent),
                         p.metric) + pen[None, :]
            dmin = D.finalize_distance(s.amin(1), p.take(p.x_sqs, cand_idx),
                                       p.metric)
            prob = dmin * dmin / q[cand_idx]
            cent[i:i + 1] = cand.index_select(0, mh_chain(
                prob, us[i - 1])).float()
            _progress(p, "afkmc2", i + 1, k)
    return cent


def afkmc2_chain_length(problem, m: int) -> int:
    """0 -> min(AFKMC2_DEFAULT_M, n_valid // 2) (at least 1); above n // 2
    raises, as the reference."""
    if m == 0:
        return min(config.AFKMC2_DEFAULT_M, max(1, problem.n_valid // 2))
    if m > problem.n // 2:
        raise KMTPUInvalidArguments(
            "afkmc2: m > %d is not supported (got %d)" % (problem.n // 2, m))
    return m


@P.spanned("kmt.init")
def init_centroids(problem, method: InitMethod, seed: int, afkmc2_m: int = 0,
                   imported=None) -> torch.Tensor:
    """Returns (k, F) fp32 centroids on the problem's device.  Counts the
    k - 1 steps of k-means++ and AFK-MC2 as ``init.steps`` here, and not in
    their loops, which the Yinyang grouping runs too."""
    p = problem
    if method == InitMethod.IMPORT:
        return _imported(p, imported)
    gen = generator(seed)
    if method == InitMethod.RANDOM:
        p.logger.info("performing random centroid initialization...")
        return _random(p, gen)
    if method == InitMethod.PLUS_PLUS:
        p.logger.info("performing kmeans++...")
        P.count("init.steps", p.k - 1)
        return _init_plus_plus(p, gen)
    if method == InitMethod.AFKMC2:
        m = afkmc2_chain_length(p, afkmc2_m)
        p.logger.info("performing afkmc2 (m = %d)..." % m)
        P.count("init.steps", p.k - 1)
        return _init_afkmc2(p, m, gen)
    raise KMTPUInvalidArguments("unknown init method %r" % (method,))
