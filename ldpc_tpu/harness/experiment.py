"""Monte-Carlo FER experiment harness.

Batched re-design of the reference pthread harness (``experiment.h``):

* the mutex-guarded dynamic work queue (``experiment.h:86-93``) becomes a
  *static* sharding of the trial index space — valid because per-trial
  randomness is index-derived, not order-derived (``experiment.h:97`` seeds
  ``mt19937 rnd(trial_index+1)``; we use ``jax.random.fold_in(key, index)``);
* per-thread counter structs merged by summation (``merge_exp_results``,
  ``experiment.h:70-78``) become a single ``jnp.sum`` over the (sharded)
  batch axis — XLA inserts the cross-device ``psum``;
* classification semantics match ``exp`` (``experiment.h:109-118``):
  ``correct``  = certificate && valid codeword && equals the transmitted word,
  ``pseudo``   = certificate && valid codeword && differs (pseudocodeword),
  everything else is a frame error. The reference tracks but never reports
  ``pseudo`` (``main.cpp:79-86``); we report it.
* the Hamming tracker (``experiment.h:25-47``) counts channel hard-decision
  errors (y<=0 for bit 0, y>0 for bit 1) split by correct/wrong.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..channel.awgn import bpsk, llr_variance
from ..codes.gf2 import is_codeword
from ..decoders.base import Decoder

__all__ = ["ExperimentResult", "run_experiment", "make_experiment_step",
           "run_multi_snr_experiment", "run_streaming_experiment"]


@dataclass
class ExperimentResult:
    """Aggregated counters; derived metrics mirror ``experiment.h:49-68``."""

    total: int = 0
    correct: int = 0
    pseudo: int = 0
    sum_hamming: int = 0
    sum_hamming_ok: int = 0
    sum_hamming_wrong: int = 0
    time_sec: float = 0.0          # wall-clock decode time (whole batches)
    sum_iterations: int = 0        # extra diagnostic (not in reference)
    sum_dropped: int = 0           # resource-exhaustion telemetry (base.py)

    @property
    def fer(self) -> float:
        return (self.total - self.correct) / max(1, self.total)

    @property
    def avg_time(self) -> float:
        """Seconds per codeword. NOTE: the reference's Time column is
        single-thread decode latency (``experiment.h:100-103``); ours is
        wall-clock / trials on the whole accelerator — document both."""
        return self.time_sec / max(1, self.total)

    @property
    def throughput(self) -> float:
        return self.total / self.time_sec if self.time_sec > 0 else float("inf")

    @property
    def mean_hamming(self) -> float:
        return self.sum_hamming / max(1, self.total)

    @property
    def mean_hamming_ok(self) -> float:
        return self.sum_hamming_ok / max(1, self.correct)

    @property
    def mean_hamming_wrong(self) -> float:
        return self.sum_hamming_wrong / max(1, self.total - self.correct)

    def merge(self, other: "ExperimentResult") -> None:
        for f in ("total", "correct", "pseudo", "sum_hamming",
                  "sum_hamming_ok", "sum_hamming_wrong", "time_sec",
                  "sum_iterations", "sum_dropped"):
            setattr(self, f, getattr(self, f) + getattr(other, f))


def _per_trial_counter_cap(decoder: Decoder, n: int) -> int:
    """Max per-trial contribution to any int32 fused-scan counter: Hamming
    distance <= n, total <= 1, and iterations <= the decoder's per-trial
    iteration cap (QP-ADMM's max_iter=10000 dwarfs n+1, so bounding by
    n+1 alone would admit trial counts whose sum_iterations overflows)."""
    return max(n + 1, int(getattr(decoder, "max_iter", 0)),
               int(getattr(decoder, "max_rounds", 0)))


def make_experiment_step(decoder: Decoder, h, snr: float, base_key,
                         donate: bool = True):
    """Build the jitted one-batch experiment step.

    step(codewords (B, n) uint8, trial_idx (B,) int32) -> counters dict.
    All compute — channel, decode, classification, reduction — is one XLA
    program; with sharded inputs the final sums become psums over the mesh.
    """
    h_dev = jnp.asarray(np.asarray(h), jnp.uint8)
    sigma = float(np.sqrt(float(llr_variance(snr))))
    inv_var = float(2.0 / float(llr_variance(snr)))

    def step(codewords, trial_idx):
        keys = jax.vmap(lambda i: jax.random.fold_in(base_key, i))(trial_idx)
        noise = jax.vmap(
            lambda k: jax.random.normal(k, (decoder.n,), jnp.float32))(keys)
        y = bpsk(codewords) + sigma * noise
        llrs = inv_var * y
        res = decoder.decode_batch(llrs)
        valid = res.success & is_codeword(h_dev, res.bits)
        match = jnp.all(res.bits == codewords, axis=-1)
        correct = valid & match
        pseudo = valid & ~match
        # channel hard-decision Hamming distance (experiment.h:33-46)
        hd = jnp.sum(jnp.where(codewords == 0, y <= 0, y > 0), axis=-1)
        # per-batch counters fit int32 comfortably (B*n < 2^31); the host
        # accumulates across batches in Python ints
        c64 = lambda x: jnp.sum(x.astype(jnp.int32))
        return {
            "total": jnp.asarray(codewords.shape[0], jnp.int32),
            "correct": c64(correct),
            "pseudo": c64(pseudo),
            "sum_hamming": c64(hd),
            "sum_hamming_ok": c64(jnp.where(correct, hd, 0)),
            "sum_hamming_wrong": c64(jnp.where(correct, 0, hd)),
            "sum_iterations": c64(res.iterations),
            "sum_dropped": (c64(res.dropped) if res.dropped is not None
                            else jnp.int32(0)),
        }

    return jax.jit(step)


def make_multi_snr_step(decoder: Decoder, h, snrs, base_key):
    """One-batch experiment step with a *per-lane* SNR — the SNR sweep axis
    fused into the decode batch (SURVEY.md §2, parallelism item 2).

    Decoders consume only LLRs, so lanes at different SNR points coexist in
    one decode program; counters are reduced per SNR with a masked sum.
    step(codewords (B, n), trial_idx (B,), snr_id (B,)) ->
    dict of (S,) arrays.
    """
    h_dev = jnp.asarray(np.asarray(h), jnp.uint8)
    snrs_v = jnp.asarray(np.asarray(snrs, np.float32))
    s_count = len(np.asarray(snrs))
    sigmas = jnp.sqrt(jnp.power(10.0, -snrs_v / 10.0) / 2.0)
    inv_vars = 2.0 / (sigmas * sigmas)

    def step(codewords, trial_idx, snr_id):
        keys = jax.vmap(lambda i: jax.random.fold_in(base_key, i))(trial_idx)
        noise = jax.vmap(
            lambda k: jax.random.normal(k, (decoder.n,), jnp.float32))(keys)
        sig = sigmas[snr_id][:, None]
        y = bpsk(codewords) + sig * noise
        llrs = inv_vars[snr_id][:, None] * y
        res = decoder.decode_batch(llrs)
        valid = res.success & is_codeword(h_dev, res.bits)
        match = jnp.all(res.bits == codewords, axis=-1)
        correct = valid & match
        pseudo = valid & ~match
        hd = jnp.sum(jnp.where(codewords == 0, y <= 0, y > 0), axis=-1)
        onehot = jax.nn.one_hot(snr_id, s_count, dtype=jnp.int32)  # (B, S)

        def seg(x):
            return jnp.sum(onehot * x[:, None].astype(jnp.int32), axis=0)

        ones = jnp.ones_like(trial_idx)
        return {
            "total": seg(ones),
            "correct": seg(correct),
            "pseudo": seg(pseudo),
            "sum_hamming": seg(hd),
            "sum_hamming_ok": seg(jnp.where(correct, hd, 0)),
            "sum_hamming_wrong": seg(jnp.where(correct, 0, hd)),
            "sum_iterations": seg(res.iterations),
            "sum_dropped": (seg(res.dropped) if res.dropped is not None
                            else jnp.zeros((s_count,), jnp.int32)),
        }

    return jax.jit(step)


def run_multi_snr_experiment(decoder: Decoder, h, codewords, snrs, key,
                             batch_size: int = 2048, sharding=None,
                             warmup: bool = True) -> list[ExperimentResult]:
    """Run the whole SNR sweep as one fused trial stream.

    The (snr, trial) grid is flattened, interleaved so every batch mixes SNR
    points (keeps early-exit iteration counts balanced per batch), and
    decoded in fixed-size batches; per-SNR counters come back from a masked
    reduction. Returns one ExperimentResult per SNR (same order as ``snrs``),
    each with the sweep's aggregate wall-clock apportioned by trial count.
    """
    cw = np.asarray(codewords, dtype=np.uint8)
    t_total, n = cw.shape
    snrs = list(snrs)
    s_count = len(snrs)
    step = make_multi_snr_step(decoder, h, snrs, key)

    # lane plan: (snr_id, trial_idx) for every pair, SNR-interleaved
    snr_ids = np.tile(np.arange(s_count, dtype=np.int32), t_total)
    trial_idx = np.repeat(np.arange(t_total, dtype=np.int32), s_count)
    total_lanes = s_count * t_total

    # fused single-device path: one upload, lax.scan over batches, one
    # fetch (see run_experiment)
    if (sharding is None and total_lanes % batch_size == 0
            and t_total * _per_trial_counter_cap(decoder, n) < 2**31):
        n_batches = total_lanes // batch_size

        @jax.jit
        def run_all(cw_all, tidx_all, sid_all):
            def body(acc, i):
                s0 = i * batch_size
                batch = jax.lax.dynamic_slice_in_dim(tidx_all, s0,
                                                     batch_size)
                sid = jax.lax.dynamic_slice_in_dim(sid_all, s0, batch_size)
                out = step(jnp.take(cw_all, batch, axis=0), batch, sid)
                return jax.tree.map(jnp.add, acc, out), None

            zeros = {k: jnp.zeros((s_count,), jnp.int32) for k in (
                "total", "correct", "pseudo", "sum_hamming",
                "sum_hamming_ok", "sum_hamming_wrong", "sum_iterations",
                "sum_dropped")}
            acc, _ = jax.lax.scan(
                body, zeros, jnp.arange(n_batches, dtype=jnp.int32))
            return acc

        args = (jnp.asarray(cw), jnp.asarray(trial_idx),
                jnp.asarray(snr_ids))
        if warmup:
            jax.device_get(run_all(*args))
        t_start = time.perf_counter()
        agg_dev = jax.device_get(run_all(*args))
        elapsed = time.perf_counter() - t_start
        results = []
        for si in range(s_count):
            results.append(ExperimentResult(
                total=int(agg_dev["total"][si]),
                correct=int(agg_dev["correct"][si]),
                pseudo=int(agg_dev["pseudo"][si]),
                sum_hamming=int(agg_dev["sum_hamming"][si]),
                sum_hamming_ok=int(agg_dev["sum_hamming_ok"][si]),
                sum_hamming_wrong=int(agg_dev["sum_hamming_wrong"][si]),
                sum_iterations=int(agg_dev["sum_iterations"][si]),
                sum_dropped=int(agg_dev["sum_dropped"][si]),
                time_sec=elapsed / s_count))
        return results

    def place(*arrs):
        out = []
        for a in arrs:
            d = jnp.asarray(a)
            if sharding is not None and d.shape[0] % sharding.num_devices == 0:
                sh = (sharding.batch_sharding if d.ndim > 1
                      else sharding.index_sharding)
                d = jax.device_put(d, sh)
            out.append(d)
        return out

    starts = list(range(0, total_lanes, batch_size))
    if warmup:
        shapes = {min(batch_size, total_lanes - s) for s in starts}
        for bsz in shapes:
            out = step(*place(cw[trial_idx[:bsz]], trial_idx[:bsz],
                              snr_ids[:bsz]))
            jax.device_get(out)

    # device-side accumulation + single fetch per flush (see run_experiment)
    agg = {}

    def flush(acc):
        host = jax.device_get(acc)
        for k, v in host.items():
            agg[k] = agg.get(k, 0) + v.astype(np.int64)

    acc = None
    n_acc = 0
    t_start = time.perf_counter()
    for s in starts:
        e = min(s + batch_size, total_lanes)
        sl = slice(s, e)
        out = step(*place(cw[trial_idx[sl]], trial_idx[sl], snr_ids[sl]))
        acc = out if acc is None else _add_counters(acc, out)
        n_acc += 1
        if n_acc >= 64:
            flush(acc)
            acc, n_acc = None, 0
    if acc is not None:
        flush(acc)
    elapsed = time.perf_counter() - t_start
    results = []
    for si in range(s_count):
        results.append(ExperimentResult(
            total=int(agg["total"][si]), correct=int(agg["correct"][si]),
            pseudo=int(agg["pseudo"][si]),
            sum_hamming=int(agg["sum_hamming"][si]),
            sum_hamming_ok=int(agg["sum_hamming_ok"][si]),
            sum_hamming_wrong=int(agg["sum_hamming_wrong"][si]),
            sum_iterations=int(agg["sum_iterations"][si]),
            sum_dropped=int(agg["sum_dropped"][si]),
            time_sec=elapsed / s_count))
    return results


def run_experiment(decoder: Decoder, h, codewords, snr: float, key,
                   batch_size: int = 1024, sharding=None,
                   warmup: bool = True,
                   streaming: str | bool = "auto") -> ExperimentResult:
    """Run FER estimation over all ``codewords`` at one SNR.

    ``codewords``: (T, n) uint8 (host or device). Trials are processed in
    fixed-size batches (the last batch is padded; padded lanes are dropped
    from the counters by masking through trial_idx < T).

    ``streaming``: decoders exposing the streaming protocol are run through
    :func:`run_streaming_experiment` (converged-lane draining — the batched
    path stalls whole batches on straggler lanes). "auto" enables it on a
    single device when the trial stream is long enough to matter.
    """
    if streaming == "auto":
        streaming = (sharding is None and hasattr(decoder, "stream_init")
                     and getattr(decoder, "prefer_streaming", True)
                     and len(codewords) >= 2 * batch_size)
    if streaming:
        return run_streaming_experiment(decoder, h, codewords, snr, key,
                                        batch_size=batch_size, warmup=warmup)
    cw = np.asarray(codewords, dtype=np.uint8)
    t_total, n = cw.shape
    step = make_experiment_step(decoder, h, snr, key)

    # Single-device fused path: the codeword table uploads ONCE and the
    # whole batch loop runs on device as a lax.scan with device-side counter
    # accumulation — one dispatch, one result fetch. The host-loop variant
    # below pays a dispatch and a codeword upload per batch. int32 counter
    # bound: the scan
    # accumulates sum_hamming <= T*n and sum_iterations <= T*max_iter, so
    # the fused path requires T*_per_trial_counter_cap < 2^31 (beyond that
    # the host loop flushes every 64 batches).
    if (sharding is None and t_total % batch_size == 0
            and t_total * _per_trial_counter_cap(decoder, n) < 2**31):
        n_batches = t_total // batch_size
        base_idx = jnp.arange(batch_size, dtype=jnp.int32)

        @jax.jit
        def run_all(cw_all):
            def body(acc, i):
                batch = jax.lax.dynamic_slice(
                    cw_all, (i * batch_size, 0), (batch_size, n))
                out = step(batch, i * batch_size + base_idx)
                return jax.tree.map(jnp.add, acc, out), None

            zeros = {k: jnp.int32(0) for k in (
                "total", "correct", "pseudo", "sum_hamming",
                "sum_hamming_ok", "sum_hamming_wrong", "sum_iterations",
                "sum_dropped")}
            acc, _ = jax.lax.scan(
                body, zeros, jnp.arange(n_batches, dtype=jnp.int32))
            return acc

        cw_dev = jnp.asarray(cw)
        if warmup:
            jax.device_get(run_all(cw_dev))  # compile outside the timing
        t_start = time.perf_counter()
        result = _fetch_counters(run_all(cw_dev))
        result.time_sec = time.perf_counter() - t_start
        return result

    def place(batch, idx):
        b_dev, i_dev = jnp.asarray(batch), jnp.asarray(idx)
        if sharding is not None and b_dev.shape[0] % sharding.num_devices == 0:
            b_dev = jax.device_put(b_dev, sharding.batch_sharding)
            i_dev = jax.device_put(i_dev, sharding.index_sharding)
        return b_dev, i_dev

    # batch plan: full batches + one remainder batch (own compiled shape)
    batches = []
    start = 0
    while start < t_total:
        stop = min(start + batch_size, t_total)
        batches.append((start, stop))
        start = stop

    if warmup:  # compile every distinct shape outside the timed region
        shapes = {stop - start for start, stop in batches}
        for bsz in shapes:
            out = step(*place(cw[:bsz], np.arange(bsz, dtype=np.int32)))
            jax.device_get(out)

    # Counters are accumulated ON DEVICE with a jitted tree-add and fetched
    # once per flush, so the host does not wait on every batch. Flush every
    # 64 batches to keep int32 counters far from overflow on huge sweeps.
    result = ExperimentResult()
    acc = None
    n_acc = 0
    t_start = time.perf_counter()
    for start, stop in batches:
        idx = np.arange(start, stop, dtype=np.int32)
        out = step(*place(cw[start:stop], idx))
        acc = out if acc is None else _add_counters(acc, out)
        n_acc += 1
        if n_acc >= 64:
            result.merge(_fetch_counters(acc))
            acc, n_acc = None, 0
    if acc is not None:
        result.merge(_fetch_counters(acc))
    result.time_sec = time.perf_counter() - t_start
    return result


def run_streaming_experiment(decoder, h, codewords, snr: float, key,
                             batch_size: int = 256, fetch_every: int = 4,
                             warmup: bool = True,
                             sharding=None) -> ExperimentResult:
    """FER estimation with converged-lane draining (straggler fix).

    The reference's pthread work queue (``experiment.h:86-93``) gives every
    thread a new trial the moment it finishes one. ``run_experiment``'s
    batched analogue loses that property for iterative decoders whose
    ``decode_batch`` runs a whole-batch ``lax.while_loop``: one stubborn
    lane holds the other B-1 at its max_iter. This runner restores it
    on-device: decoders exposing the streaming protocol (``stream_init`` /
    ``stream_chunk`` / ``stream_done`` / ``stream_finish``) are advanced in
    fixed-iteration chunks; after each chunk, finished lanes are classified
    into device-side counters and their slots refilled with fresh trials
    (channel generated on-device from the codeword table via per-trial
    ``fold_in`` — identical noise to the batched path, so per-trial decode
    results are bit-identical). The host only polls a scalar active-lane
    count every ``fetch_every`` chunks.

    ``sharding``: optional :class:`ldpc_tpu.parallel.mesh.TrialSharding`.
    The lane axis (solver state, trial indices, codewords) is placed on the
    mesh's trial axis after initialization; jit propagates the shardings
    through every chunk, so lane-local work stays device-local and the
    scalar counter updates lower to cross-device reductions — the streaming
    analogue of the batched runner's counter psum (``merge_exp_results``,
    ``experiment.h:70-78``). Requires ``batch_size % num_devices == 0``.
    """
    cw = np.asarray(codewords, dtype=np.uint8)
    t_total, n = cw.shape
    h_dev = jnp.asarray(np.asarray(h), jnp.uint8)
    cw_dev = jnp.asarray(cw)
    sigma = float(np.sqrt(float(llr_variance(snr))))
    inv_var = float(2.0 / float(llr_variance(snr)))
    bsz = int(batch_size)

    def make_lane(idx):
        """(B,) trial indices -> (llrs, codeword bits, channel hamming)."""
        safe = jnp.clip(idx, 0, t_total - 1)
        cwb = jnp.take(cw_dev, safe, axis=0)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(safe)
        noise = jax.vmap(
            lambda k: jax.random.normal(k, (n,), jnp.float32))(keys)
        y = bpsk(cwb) + sigma * noise
        hd = jnp.sum(jnp.where(cwb == 0, y <= 0, y > 0),
                     axis=-1).astype(jnp.int32)
        return inv_var * y, cwb, hd

    zero_counters = {k: jnp.int32(0) for k in (
        "total", "correct", "pseudo", "sum_hamming", "sum_hamming_ok",
        "sum_hamming_wrong", "sum_iterations", "sum_dropped")}

    def start():
        idx0 = jnp.arange(bsz, dtype=jnp.int32)
        llrs, cwb, hd = make_lane(idx0)
        st = decoder.stream_init(llrs)
        active = idx0 < t_total
        # lanes beyond the trial count start frozen
        st["done"] = st["done"] | ~active
        return (st, idx0, cwb, hd, active, jnp.int32(min(bsz, t_total)),
                dict(zero_counters))

    def step(carry):
        st, idx, cwb, hd, active, consumed, counters = carry
        st = decoder.stream_chunk(st)
        fin = decoder.stream_done(st) & active
        res = decoder.stream_finish(st)
        valid = res.success & is_codeword(h_dev, res.bits)
        match = jnp.all(res.bits == cwb, axis=-1)
        correct = valid & match & fin
        pseudo = valid & ~match & fin
        c32 = lambda x: jnp.sum(x.astype(jnp.int32))
        counters = {
            "total": counters["total"] + c32(fin),
            "correct": counters["correct"] + c32(correct),
            "pseudo": counters["pseudo"] + c32(pseudo),
            "sum_hamming": counters["sum_hamming"]
                + c32(jnp.where(fin, hd, 0)),
            "sum_hamming_ok": counters["sum_hamming_ok"]
                + c32(jnp.where(correct, hd, 0)),
            "sum_hamming_wrong": counters["sum_hamming_wrong"]
                + c32(jnp.where(fin & ~correct, hd, 0)),
            "sum_iterations": counters["sum_iterations"]
                + c32(jnp.where(fin, res.iterations, 0)),
            "sum_dropped": counters["sum_dropped"]
                + (c32(jnp.where(fin, res.dropped, 0))
                   if res.dropped is not None else 0),
        }
        # refill finished slots with the next trials from the stream
        rank = jnp.cumsum(fin.astype(jnp.int32))
        new_idx = consumed + rank - 1
        idx = jnp.where(fin, new_idx, idx)
        active = jnp.where(fin, new_idx < t_total, active)
        consumed = consumed + rank[-1]
        llrs, cwb_new, hd_new = make_lane(idx)
        fresh = decoder.stream_init(llrs)
        st = jax.tree.map(
            lambda f, o: jnp.where(
                fin.reshape((bsz,) + (1,) * (o.ndim - 1)), f, o), fresh, st)
        cwb = jnp.where(fin[:, None], cwb_new, cwb)
        hd = jnp.where(fin, hd_new, hd)
        # inactive lanes stay frozen through future chunks
        st["done"] = st["done"] | ~active
        return (st, idx, cwb, hd, active, consumed, counters), c32(active)

    start_j = jax.jit(start)
    step_j = jax.jit(step, donate_argnums=0)

    def place(carry):
        """Shard the lane axis of the carry over the mesh's trial axis."""
        if sharding is None:
            return carry
        assert bsz % sharding.num_devices == 0, (bsz, sharding.num_devices)

        def put(x):
            if getattr(x, "ndim", 0) >= 1 and x.shape[0] == bsz:
                return jax.device_put(
                    x, sharding.batch_sharding if x.ndim > 1
                    else sharding.index_sharding)
            return x
        st, idx, cwb, hd, active, consumed, counters = carry
        return (jax.tree.map(put, st), put(idx), put(cwb), put(hd),
                put(active), consumed, counters)

    if warmup:
        carry = place(start_j())
        jax.device_get(step_j(carry)[1])  # compile both programs

    t_start = time.perf_counter()
    carry = place(start_j())
    n_active = None
    t_poll = time.perf_counter()
    while True:
        for _ in range(fetch_every):
            carry, n_active = step_j(carry)
        if int(jax.device_get(n_active)) == 0:
            break
        # Adaptive poll thinning: the device_get above is a host sync. For
        # fast chunks (BP / ADMM) syncing every few chunks leaves the device
        # waiting on the host, so double the chunks-per-poll while polls
        # come back quickly. Overshoot after the last lane converges is
        # cheap: a chunk with every lane done is a skipped lax.cond plus
        # counter no-ops.
        now = time.perf_counter()
        if now - t_poll < 0.25 and fetch_every < 128:
            fetch_every *= 2
        t_poll = now
    counters = carry[-1]
    result = _fetch_counters(counters)
    result.time_sec = time.perf_counter() - t_start
    return result


@jax.jit
def _add_counters(a, b):
    return jax.tree.map(jnp.add, a, b)


def _fetch_counters(acc) -> ExperimentResult:
    host = {k: int(v) for k, v in jax.device_get(acc).items()}
    return ExperimentResult(
        total=host["total"], correct=host["correct"],
        pseudo=host["pseudo"], sum_hamming=host["sum_hamming"],
        sum_hamming_ok=host["sum_hamming_ok"],
        sum_hamming_wrong=host["sum_hamming_wrong"],
        sum_iterations=host["sum_iterations"],
        sum_dropped=host.get("sum_dropped", 0))
