"""Conference mixing with mix-minus, small mixers and per-leg levels (port
of ``mediastreamer2_tpu/ops/mixer.py``).

Conference members are rows of the batch. ``group_id[b]`` names the
conference of leg b; each leg hears its conference's sum minus its own
contribution, clipped to [-1, 1] like the reference's int16 clamp.

Two branches, as in JAX:

* ``uniform_group_size=k`` (the flagship's): contiguous groups of k legs,
  a reshape-sum.
* otherwise a segment sum over ``group_id``. The legs are sorted by group
  (a stable sort, once per new ``group_id`` tensor or in-place change of
  it), and ``torch.segment_reduce`` sums each group's rows in that fixed
  order, one thread per output element on CUDA: no atomics (an
  ``index_add_`` there changes its summation order from run to run),
  O(B * S) work and memory. An id outside [0, B) joins no group, as in
  ``jax.ops.segment_sum``.

Built for one shard of the legs (``FilterCtx.shard``,
``parallel/sharding.py``), the mixer is bit for bit the unsharded one. JAX
leaves the cross-shard sums to XLA, which picks its own collective; the
port names its own: ranks exchange *contributions*, never partial sums,
through one ``all_reduce`` over a zero-padded buffer of their bits
(``core/collective.sum_exact``: each slot has one non-zero writer, so the sum is
the value), then each rank runs the unsharded code's own sum on the rows
it needs, in the unsharded order:

* uniform groups: the branch is picked from the whole batch; when every
  group lies inside one shard (decided from ``global_batch``, ``k`` and
  ``world``, which all ranks share) nothing is exchanged; otherwise only
  the groups a shard boundary cuts;
* segment sum: ``group_id`` may put any leg anywhere and change at run
  time, so every tick every rank gets the whole ``[global_batch, S]``
  contribution buffer with each leg's (global) group id as one more
  column, sorts those ids and reduces; the ``_segments`` cache, which
  counts B + 1 offsets from its own rows, is not used.

``mix2``/``mix3``/``mix4`` sum their inputs with per-input gains and clip;
``audio_levels`` passes audio through and meters each leg's smoothed block
energy (the conference's active-talker and RFC 6464/6465 level source).
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.collective import exchange_rows, sum_exact
from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter


def _conf_params(ctx, device):
    B = ctx.batch
    return {
        "group_id": torch.arange(B, dtype=torch.int32, device=device),  # everyone alone
        "gain": torch.ones((B,), dtype=torch.float32, device=device),
        "active": torch.ones((B,), dtype=torch.bool, device=device),
        "mix_minus": torch.ones((B,), dtype=torch.bool, device=device),
        "out_gain": torch.ones((B,), dtype=torch.float32, device=device),
    }


def _segments(ctx, gid):
    """(order, offsets): the legs sorted by group id, stably, and where each
    of the B possible groups starts in that order (B + 1 offsets), cached on
    ``ctx`` until ``group_id`` is replaced or changed in place (its version
    counter), so that a tick reuses them without a sort or a host sync."""
    cached = getattr(ctx, "_segments", None)
    if cached is None or cached[0] is not gid or cached[1] != gid._version:
        cached = (gid, gid._version) + _sort_segments(gid)
        ctx._segments = cached
    return cached[2], cached[3]


def _sort_segments(gid):
    """(order, offsets) of ``_segments``, uncached."""
    ids, order = torch.sort(gid, stable=True)
    return order, torch.searchsorted(ids, torch.arange(gid.shape[0] + 1, dtype=ids.dtype,
                                                       device=gid.device))


def _uniform_mix(contrib, k):
    """Each row's group sum, for contiguous groups of ``k`` rows."""
    B, S = contrib.shape
    return torch.repeat_interleave(contrib.reshape(B // k, k, S).sum(dim=1), k, dim=0)


def _segment_sums(contrib, order, offsets):
    """[B groups, S]: each group's rows summed in ``order``."""
    return torch.segment_reduce(contrib[order], "sum", offsets=offsets, axis=0, unsafe=True)


def spanning_groups(global_batch, k, world):
    """The uniform groups of ``k`` legs that a boundary between two of
    ``world`` shards cuts, from numbers every rank shares (so that every
    rank takes part in the same exchange, or none does)."""
    b = global_batch // world
    return sorted({(j * b) // k for j in range(1, world) if (j * b) % k})


def _sharded_uniform_mix(contrib, k, shard):
    """``_uniform_mix`` of a shard's rows: groups inside the shard sum
    there; the rows of groups that a shard boundary cuts are exchanged
    (only those), then every rank sums the whole groups its rows belong
    to with the unsharded code."""
    B, S = contrib.shape
    spanning = spanning_groups(shard.global_batch, k, shard.world)
    if not spanning:
        return _uniform_mix(contrib, k)
    off = shard.offset
    slot = {g: i * k for i, g in enumerate(spanning)}      # group -> first buffer row
    buf = torch.zeros((len(spanning) * k, S), dtype=contrib.dtype, device=contrib.device)
    for g in spanning:
        lo, hi = max(g * k, off), min(g * k + k, off + B)
        if lo < hi:
            buf[slot[g] + lo - g * k:slot[g] + hi - g * k] = contrib[lo - off:hi - off]
    buf = sum_exact(buf, shard.group)
    g0, g1 = off // k, (off + B - 1) // k                 # the groups this shard touches
    left, right = off - g0 * k, (g1 + 1) * k - (off + B)
    rows = [buf[slot[g0]:slot[g0] + left]] if left else []
    rows.append(contrib)
    if right:
        rows.append(buf[slot[g1] + k - right:slot[g1] + k])
    return _uniform_mix(torch.cat(rows), k)[left:left + B]


def _conf_process(state, ins, params, ctx):
    x = ins[0]                                        # [B, S]
    B, S = x.shape
    contrib = torch.where(params["active"][:, None], x * params["gain"][:, None], 0.0)
    k = int(ctx.params.get("uniform_group_size", 0))
    shard = ctx.shard
    if k > 0 and ctx.global_batch % k == 0:
        mix = _uniform_mix(contrib, k) if shard is None else \
            _sharded_uniform_mix(contrib, k, shard)
    elif shard is None:
        gid = params["group_id"]
        order, offsets = _segments(ctx, gid)
        mix = _segment_sums(contrib, order, offsets)[gid.long()]
    else:
        # every leg's contribution and group id, exactly, on every rank
        # (one collective: the ids ride as a last column of the bits)
        bits = torch.cat([contrib.view(torch.int32),
                          params["group_id"].to(torch.int32)[:, None]], dim=1)
        full = exchange_rows(bits, shard.offset, shard.global_batch, shard.group)
        contrib_g, gid_g = full[:, :S].contiguous().view(torch.float32), full[:, S]
        sums = _segment_sums(contrib_g, *_sort_segments(gid_g))
        mix = sums[gid_g[shard.offset:shard.offset + B].long()]
    out = torch.where(params["mix_minus"][:, None], mix - contrib, mix)
    out = torch.clamp(out * params["out_gain"][:, None], -1.0, 1.0)
    return state, (out,), {}


register_filter(FilterDef(
    name="conf_mixer", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    runtime_params=_conf_params, process=_conf_process,
    interfaces=("conference",),
))


# --- small explicit mixers (graph-local, e.g. local play, mixed recording) --
def _mk_mixN(n):
    def process(state, ins, params, ctx):
        acc = ins[0] * params["gains"][0][:, None]
        for i in range(1, n):
            acc = acc + ins[i] * params["gains"][i][:, None]
        return state, (torch.clamp(acc, -1.0, 1.0),), {}

    def rparams(ctx, device):
        return {"gains": torch.ones((n, ctx.batch), dtype=torch.float32, device=device)}

    register_filter(FilterDef(
        name=f"mix{n}", ninputs=n, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0],),
        runtime_params=rparams, process=process,
    ))


for _n in (2, 3, 4):
    _mk_mixN(_n)


# --- RFC 6464/6465-style per-member levels for speaker selection ------------
def _levels_process(state, ins, params, ctx):
    x = ins[0]
    sm = 0.7 * state["energy"] + 0.3 * (x * x).mean(dim=1)
    return {"energy": sm}, (x,), {"level": sm}


register_filter(FilterDef(
    name="audio_levels", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=lambda ctx, device: {"energy": torch.zeros((ctx.batch,), dtype=torch.float32,
                                                    device=device)},
    process=_levels_process,
))
