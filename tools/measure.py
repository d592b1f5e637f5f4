"""Device-true timing.

JAX dispatch is asynchronous, so naive per-pass timing can measure dispatch
latency instead of compute. The method:

1. Jit a `lax.scan` of K render passes reduced to ONE scalar, and fetch that
   scalar to the host (`float(...)`). The fetch is a true data dependency —
   the host cannot observe the value without every pass having run.
2. Time the whole program at two pass counts K1 < K2 (both pre-compiled) and
   report the *marginal* cost (t2 - t1) / (K2 - K1). This cancels fixed
   overheads: compile-cache lookup, dispatch, host<->device transfer.
3. Use fresh, salted PRNG keys each timing rep so no seen-key/caching
   fast-path can short-circuit the work.
"""

from __future__ import annotations

import functools
import os
import statistics
import time
from typing import Callable

import jax
import jax.numpy as jnp


def fresh_salt() -> int:
    return int.from_bytes(os.urandom(4), "little") % (2**30)


def make_scan_loop(pass_fn: Callable[..., jnp.ndarray]):
    """Jit a loop running `pass_fn` `passes` times with per-pass folded keys,
    reduced to one scalar (the host-fetch barrier). Extra `operands` are
    passed through as jit ARGUMENTS — large arrays a pass closes over would
    otherwise be baked into the program as constants."""

    @functools.partial(jax.jit, static_argnames=("passes",))
    def loop(key: jax.Array, passes: int, *ops) -> jnp.ndarray:
        def body(acc, p):
            k = jax.random.fold_in(key, p)
            return acc + pass_fn(k, *ops).sum(), None

        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(passes))
        return acc

    return loop


def marginal_seconds_per_pass(
    pass_fn: Callable[[jax.Array], jnp.ndarray],
    *,
    k1: int = 4,
    k2: int = 12,
    reps: int = 3,
    return_all: bool = False,
    operands: tuple = (),
):
    """(median marginal seconds/pass, checksum of last run) — or, with
    `return_all`, (median, checksum, sorted marginals list) so callers can
    record the spread.

    The checksum is returned so callers can assert it is finite — a backend
    that skipped the work would produce garbage or hang, not a plausible sum.
    """
    loop = make_scan_loop(pass_fn)

    # compile both shapes (untimed)
    warm_key = jax.random.PRNGKey(fresh_salt())
    float(loop(warm_key, k1, *operands))
    float(loop(warm_key, k2, *operands))

    marginals = []
    checksum = 0.0
    for _ in range(reps):
        key = jax.random.PRNGKey(fresh_salt())
        t0 = time.perf_counter()
        float(loop(key, k1, *operands))
        d1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        checksum = float(loop(key, k2, *operands))
        d2 = time.perf_counter() - t0
        if d2 <= d1:
            # timing noise swamped the extra passes; rep is unusable
            continue
        marginals.append((d2 - d1) / (k2 - k1))
    if not marginals:
        raise RuntimeError("timing reps all showed dt(K2) <= dt(K1); too noisy")
    if return_all:
        return statistics.median(marginals), checksum, sorted(marginals)
    return statistics.median(marginals), checksum
