"""Contextual autotuner: measure candidate configs on the card, agree across
processes, persist winners.

Counterpart of ``triton_distributed_tpu/tune/autotuner.py`` (the core,
``:134-488``, and the matmul family); reference
``python/triton_dist/autotuner.py:97-256``.  Candidates are whole thunks
closing over the caller's real tensors (the "contextual" part), timed by
the interleaved protocol of ``core.utils.interleaved_time_samples``.  With
more than one process, every candidate's time is averaged over the
processes (``core.utils.process_mean``) so each picks the same winner.
Winners persist to a JSON file keyed by (name, candidate digest, key), the
key ending in the device kind, so steady-state serving never re-tunes.

Port decisions:

- ``LibraryBackend()`` takes the place of ``XlaBackend``: dispatch to
  ``torch.matmul`` (cuBLAS).  Scoped VMEM has no meaning on Hopper, so the
  flag variants (``XLA_VMEM_SWEEP_KIB``, ``XLA_FLAG_MARGIN``) and the
  raised-budget tiles (``MATMUL_TILE_VL``) are gone and every candidate
  has one margin, :data:`PALLAS_MARGIN`.
- Only :class:`TileInfeasible` is skipped in the sweep: a wrapper raises it
  from its own checks before any launch.  Anything else a candidate raises
  on its first call (a ``build.KernelBuildError``, the ``RuntimeError`` of
  a failed launch) propagates, so a broken kernel can never quietly crown
  the library.  The JAX tuner skipped every exception.
- CPU tensors never measure: the plain PyTorch versions say nothing about
  the card, so an op called on the CPU resolves to a cached winner or the
  default.
- The obs counters and the resilience suppression of the JAX sweep come
  with the ports of ``obs/`` and ``resilience/`` (ROADMAP A15 and A14).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable, Sequence

from ..core import platform
from ..core.utils import interleaved_time_samples, process_mean, sync

_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "triton_distributed_tpu_torch",
    "autotune.json")


def cache_path() -> str:
    return os.environ.get("TDT_AUTOTUNE_CACHE", _DEFAULT_CACHE)


@dataclasses.dataclass(frozen=True)
class LibraryBackend:
    """Dispatch-to-library candidate of the GEMM-shaped ops: ``torch.matmul``
    (cuBLAS), the never-lose default the hand kernel must beat (JAX
    ``XlaBackend(0)``)."""


class TileInfeasible(ValueError):
    """A wrapper's own checks refuse the tile for these operands (a tile the
    kernel is not built for, dimensions off its granule) before anything is
    launched: the one failure the tuner skips."""


# A challenger dethrones the default only when it wins by this margin: the
# measured spread of near-tie candidates exceeds their true difference, and
# a persisted mis-crown costs every later run.
PALLAS_MARGIN = 0.08

# FRESH single-process tunes use a finer margin: their crown is used in
# this process and re-validated head to head (the confirmation pass) before
# it sticks.  A crown that clears only these is kept out of the disk cache.
FRESH_SWEEP_MARGIN = 0.015
FRESH_CONFIRM_MARGIN = 0.01

RAMP_S = 1.5   # sustained work before a fresh sweep's first timed window


@dataclasses.dataclass
class TuneResult:
    config: Any
    time_ms: float
    from_cache: bool
    # speed-of-light fraction of the winner (sol_ms / time), when the
    # caller supplied a model estimate and a fresh measurement ran
    sol_fraction: float | None = None
    # every candidate's measured ms (inf: skipped), when a measurement ran
    candidate_ms: list | None = None


def _cands_digest(candidates: Sequence[Any]) -> str:
    """Fingerprint of the candidate list: persisted winners are indices, so
    a changed sweep must miss the cache instead of re-pointing an old index
    at a different config."""
    return hashlib.sha1(str([str(c) for c in candidates]).encode()).hexdigest()[:8]


def _cache_key(name: str, key: Sequence[Any],
               candidates: Sequence[Any]) -> str:
    return json.dumps([name, _cands_digest(candidates), *map(str, key)])


def _multi_process() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _log(msg: str) -> None:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(msg, flush=True)


def _on_card() -> bool:
    import torch

    return torch.cuda.is_available()


class Autotuner:
    """Process-wide tuner with a persistent JSON winner cache."""

    def __init__(self, path: str | None = None):
        self._path = path
        self._mem: dict[str, int] = {}
        self._times: dict[str, float] = {}
        self._lock = threading.Lock()
        self._disk: dict[str, int] | None = None
        # settled resolutions, (name, key) -> config: a hot loop must not pay
        # the digest and the JSON key on every call
        self._resolved: dict = {}
        # name -> (candidates, TuneResult) of the last measurement
        self.last: dict = {}

    # -- persistence ------------------------------------------------------

    def _load_disk(self) -> dict[str, int]:
        if self._disk is None:
            try:
                with open(self._path or cache_path()) as f:
                    self._disk = {k: int(v) for k, v in json.load(f).items()}
            except (OSError, ValueError):
                self._disk = {}
        return self._disk

    def _save_disk(self) -> None:
        p = self._path or cache_path()
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            tmp = p + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._load_disk(), f, indent=1, sort_keys=True)
            os.replace(tmp, p)
        except OSError:
            pass  # caching is best-effort; winners stay in memory

    # -- timing -----------------------------------------------------------

    @staticmethod
    def _measure_interleaved(thunks: dict, iters: int, rounds: int = 5,
                             target_window_s: float = 0.15) -> dict:
        """Per-candidate median ms over interleaved rounds of ~150 ms
        windows, ranked on the raw estimator (its fixed sync cost is common
        to every candidate); round 0 predates the window calibration and is
        dropped."""
        raw = interleaved_time_samples(thunks, iters, rounds,
                                       target_window_s=target_window_s)
        out = {}
        for name, xs in raw.items():
            tail = xs[1:] if len(xs) > 1 else xs
            rs = sorted(r for _, r in tail if r > 0)
            out[name] = rs[len(rs) // 2] * 1e3 if rs else float("inf")
        return out

    def _agree(self, times: list[float]) -> list[float]:
        """Average candidate times over processes so every rank picks the
        same winner."""
        return process_mean(times)

    # -- entry ------------------------------------------------------------

    def tune(self, name: str, key: Sequence[Any], candidates: Sequence[Any],
             make_thunk: Callable[[Any], Callable[[], Any]], *,
             iters: int = 8, verbose: bool = False,
             sol_ms: float | None = None, baseline_index: int | None = None,
             margin: float = PALLAS_MARGIN,
             fresh: bool = False) -> TuneResult:
        """Pick the fastest candidate for ``key``.

        ``make_thunk(candidate)`` returns a zero-argument thunk running the
        op with that candidate.  A candidate whose first call raises
        :class:`TileInfeasible` is skipped; any other exception propagates.
        ``sol_ms`` turns the winner's time into a fraction of the roofline.
        ``baseline_index`` marks the known-good default, which a challenger
        must beat by ``margin``.
        ``fresh`` ignores cached winners and measures now; its crown always
        lands in process memory, and on disk only when it clears the full
        margin.  A fresh tune that demotes a persisted winner removes that
        disk entry either way."""
        ck = _cache_key(name, key, candidates)
        multi = _multi_process()
        if not fresh:
            with self._lock:
                if ck in self._mem:
                    return TuneResult(candidates[self._mem[ck]],
                                      self._times.get(ck, float("nan")), True)
                # the disk file is per host and may differ across hosts, so
                # only single-process runs consult it
                if not multi:
                    disk = self._load_disk()
                    if ck in disk and disk[ck] < len(candidates):
                        self._mem[ck] = disk[ck]
                        return TuneResult(candidates[disk[ck]], float("nan"),
                                          True)
        if len(candidates) == 1:
            with self._lock:
                self._mem[ck] = 0
            return TuneResult(candidates[0], float("nan"), True)

        # phase 1: build and check every candidate with one call
        live: dict[int, Callable[[], Any]] = {}
        for i, cand in enumerate(candidates):
            thunk = make_thunk(cand)
            try:
                thunk()
                sync()
            except TileInfeasible as exc:
                if multi:
                    # a skip on one rank would leave the ranks' sweeps apart
                    raise RuntimeError(
                        f"autotune[{name}] candidate {cand} is infeasible on "
                        f"this process during multi-process tuning; prune "
                        f"it before tuning") from exc
                if verbose:
                    _log(f"autotune[{name}] {cand}: skipped ({exc})")
                continue
            live[i] = thunk
        # phase 2: interleaved-round medians over the live candidates
        if fresh and not multi and live and _on_card():
            # bring the card to its steady clock before any timed window
            spin = live.get(baseline_index, next(iter(live.values())))
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < RAMP_S:
                spin()
                sync()
        if fresh and not multi:
            measured = self._measure_interleaved(dict(live), iters, rounds=9,
                                                 target_window_s=0.4)
        else:
            measured = self._measure_interleaved(dict(live), iters)
        times = [measured.get(i, float("inf")) for i in range(len(candidates))]
        if verbose:
            for i, cand in enumerate(candidates):
                _log(f"autotune[{name}] {cand}: {times[i]:.3f} ms")
        times = self._agree(times)
        best = min(range(len(candidates)), key=lambda i: times[i])
        if times[best] == float("inf"):
            raise RuntimeError(
                f"autotune[{name}]: every candidate was infeasible for key {key}")
        m = margin
        confirmed = fresh and not multi
        if confirmed:
            m = min(m, FRESH_SWEEP_MARGIN)
        if (baseline_index is not None
                and times[baseline_index] != float("inf")
                and times[best] >= (1.0 - m) * times[baseline_index]):
            best = baseline_index
        if (confirmed and baseline_index is not None and best != baseline_index
                and baseline_index in live and best in live):
            # confirmation pass: head to head with longer windows; the
            # challenger keeps the crown only if it wins by the margin and
            # wins consistently, round after round
            both = interleaved_time_samples(
                {0: live[best], 1: live[baseline_index]}, iters, rounds=8,
                target_window_s=0.4)
            pairs = [(b[1], d[1]) for b, d in zip(both[0][1:], both[1][1:])
                     if b[1] > 0 and d[1] > 0]
            wins = sum(1 for b, d in pairs
                       if b < (1.0 - FRESH_CONFIRM_MARGIN) * d)
            med_b = sorted(b for b, _ in pairs)[len(pairs) // 2] \
                if pairs else float("inf")
            med_d = sorted(d for _, d in pairs)[len(pairs) // 2] \
                if pairs else float("inf")
            consistent = (len(pairs) >= 3
                          and wins >= max(3, (3 * len(pairs)) // 4)
                          and med_b < (1.0 - FRESH_CONFIRM_MARGIN) * med_d)
            if pairs:
                times[best] = med_b * 1e3
                times[baseline_index] = med_d * 1e3
            if not consistent:
                best = baseline_index
        # a fresh crown that cleared only the fine margins serves this
        # process and is kept out of the disk cache
        process_local = (
            confirmed and baseline_index is not None
            and best != baseline_index
            and times[baseline_index] != float("inf")
            and times[best] >= (1.0 - margin) * times[baseline_index])
        with self._lock:
            self._mem[ck] = best
            self._times[ck] = times[best]
            if not process_local:
                self._load_disk()[ck] = best
                self._save_disk()
            elif self._load_disk().get(ck, best) != best:
                # the fine-margin crown contradicts a persisted winner:
                # later processes must not inherit it
                del self._load_disk()[ck]
                self._save_disk()
            self._resolved.clear()
        frac = None
        if sol_ms and times[best] > 0 and times[best] == times[best]:
            frac = sol_ms / times[best]
            if verbose:
                _log(f"autotune[{name}] winner {candidates[best]}: "
                     f"{times[best]:.3f} ms = {100 * frac:.0f}% of SOL")
        res = TuneResult(candidates[best], times[best], False, frac,
                         list(times))
        self.last[name] = (list(candidates), res)
        return res


_GLOBAL = Autotuner()


def autotune(name, key, candidates, make_thunk, **kw) -> TuneResult:
    """Tune through the process-global :class:`Autotuner`."""
    return _GLOBAL.tune(name, key, candidates, make_thunk, **kw)


def transparent_tuning_enabled() -> bool:
    """Whether a default-config op may measure candidates on its first call
    on the card.  ``TDT_AUTOTUNE=0`` opts out, ``=1`` forces on; the default
    measures whenever CUDA is present (CPU tensors never measure, see
    :func:`resolve_config`)."""
    env = os.environ.get("TDT_AUTOTUNE", "").lower()
    if env in ("0", "off", "never"):
        return False
    if env in ("1", "on", "always"):
        return True
    return _on_card()


def lookup_winner(name: str, key: Sequence[Any], candidates: Sequence[Any],
                  *, mem_only: bool = False) -> int | None:
    """Host-side cache consult (memory, then disk): the winner's index for
    ``key``, or None.  ``mem_only`` skips the per-host disk file."""
    ck = _cache_key(name, key, candidates)
    n = len(candidates)
    with _GLOBAL._lock:
        if ck in _GLOBAL._mem:
            idx = _GLOBAL._mem[ck]
            return idx if idx < n else None
        if mem_only:
            return None
        disk = _GLOBAL._load_disk()
        if ck in disk and disk[ck] < n:
            return disk[ck]
    return None


def resolve_config(name: str, key: Sequence[Any], candidates: Sequence[Any],
                   default: Any,
                   make_thunk: Callable[[Any], Callable[[], Any]], *,
                   on_card: bool, force_measure: bool = False,
                   sol_ms: float | None = None, fresh: bool = False) -> Any:
    """The default-config hook an op calls when the caller passed no config:
    the cached winner if there is one, else a measurement now when allowed,
    else ``default``.  ``on_card`` says whether the thunks run on the card;
    without it nothing is measured (JAX's ``tracing``).  ``force_measure``
    (the ``tuned_*`` entry points) measures even with transparent tuning
    off; ``fresh`` also ignores cached winners (``Autotuner.tune``).
    Returns the config; :func:`last_result` holds the measurement."""
    rk = (name, tuple(map(str, key)))
    if not fresh:
        hit = _GLOBAL._resolved.get(rk)
        if hit is not None:
            return hit
    candidates = list(candidates)
    if default not in candidates:
        # the baseline is in the sweep, before the lookup, so the digest is
        # the same on every call
        candidates = [default, *candidates]
    # with several processes only the in-process memory (written after a
    # rank-synced measurement) and the default are the same on every rank
    multi = _multi_process()
    if not fresh:
        idx = lookup_winner(name, key, candidates, mem_only=multi)
        if idx is not None:
            _GLOBAL._resolved[rk] = candidates[idx]
            return candidates[idx]
    if not on_card:
        return default
    if multi and not force_measure:
        return default
    if not (force_measure or transparent_tuning_enabled()):
        return default
    res = autotune(name, key, candidates, make_thunk, sol_ms=sol_ms,
                   baseline_index=candidates.index(default), fresh=fresh)
    _GLOBAL._resolved[rk] = res.config
    return res.config


def last_result(name: str) -> tuple[list, TuneResult] | None:
    """(candidates, result) of the process-global tuner's last measurement
    for ``name``, or None."""
    return _GLOBAL.last.get(name)


def prune_infeasible(name: str, candidates: Sequence[Any], default: Any,
                     dims: dict) -> list:
    """Drop candidates whose static footprint (``analysis.footprint``)
    cannot run at ``dims`` before anything is measured.  Deterministic in
    (name, config, dims), so every process prunes alike.  Every resolve
    path sharing a cache key must consume the same pruned list (the digest
    covers it): use the family helper (:func:`matmul_candidates_pruned`).
    The default and non-tile candidates (``LibraryBackend``) pass
    through.  Every tile K6 is built for fits its budgets, so in the
    shipped matmul sweep this drops nothing; it holds the sweep to the
    budgets once a family offers candidates that can exceed them."""
    from ..analysis import footprint

    kept = []
    for c in candidates:
        tile_like = isinstance(c, (tuple, list)) or hasattr(c, "bm")
        if c == default or not tile_like \
                or not footprint.config_feasible(name, c, dims):
            kept.append(c)
    return kept


def matmul_tile_candidates(m: int, n: int, k: int, dtype=None) -> list:
    """The (bm, bn, bk) tiles K6 is built for, for operands of ``dtype``
    (bf16 by default); tiles wider than the problem in M or N (and than 64)
    are left out unless none fits."""
    import torch

    from ..ops import matmul as mm

    tiles = list(mm.KERNEL_TILES[dtype or torch.bfloat16])
    fit = [t for t in tiles if t[0] <= max(m, 64) and t[1] <= max(n, 64)]
    return fit or tiles[-1:]


def matmul_backend_candidates(m: int, n: int, k: int, dtype=None) -> list:
    """The backend sweep of ``ops.matmul``'s ``config=None`` path: the
    library first (the never-lose baseline), then K6's tiles.  If a
    dimension is not a multiple of 8 only the library is offered, the JAX
    rule (K6 needs K and N on the 8-element granule)."""
    lib = [LibraryBackend()]
    if any(d % 8 for d in (m, n, k)):
        return lib
    return lib + matmul_tile_candidates(m, n, k, dtype)


def matmul_candidates_pruned(m: int, n: int, k: int, dtype) -> list:
    """The one candidate list every matmul resolve path (``matmul(config=
    None)``, ``matmul_callable``, ``tuned_matmul``, ``fresh_tune_matmul``)
    uses: the backend sweep with infeasible tiles pruned, so all of them
    share one digest and one winner-cache entry."""
    return prune_infeasible("matmul", matmul_backend_candidates(m, n, k, dtype),
                            LibraryBackend(), dict(m=m, n=n, k=k, dtype=dtype))


def matmul_resolve_key(m: int, n: int, k: int, dtype) -> tuple:
    """The one cache key of the matmul resolve paths."""
    return (m, n, k, str(dtype), platform.device_kind())


def _matmul_resolve(a, b, kw: dict, *, fresh: bool):
    from ..ops import matmul as mm
    from ..tools import perf_model

    (m, k), (_, n) = a.shape, b.shape
    return resolve_config(
        "matmul", matmul_resolve_key(m, n, k, a.dtype),
        matmul_candidates_pruned(m, n, k, a.dtype), LibraryBackend(),
        lambda c: (lambda: mm.matmul(a, b, config=c, **kw)),
        on_card=mm._on_card(a), force_measure=True, fresh=fresh,
        sol_ms=perf_model.gemm_sol_ms(m, n, k, a.dtype))


def tuned_matmul(a, b, **kw):
    """``ops.matmul`` with a measured backend, through the same resolver
    (and cache key) the ``config=None`` path consults."""
    from ..ops import matmul as mm

    return mm.matmul(a, b, config=_matmul_resolve(a, b, kw, fresh=False), **kw)


def fresh_tune_matmul(a, b, **kw) -> Any:
    """Re-measure the matmul backend sweep for this shape now, replacing any
    cached winner (``Autotuner.tune(fresh=True)``), so the crown matches the
    card's state in the process that will run the traffic.  Returns the
    crowned config; :func:`last_result` ("matmul") holds every candidate's
    time and the winner's fraction of the roofline."""
    return _matmul_resolve(a, b, kw, fresh=True)
