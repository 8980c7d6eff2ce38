"""Link calibration feeding the collectives' method choice (counterpart of
``triton_distributed_tpu/tools/calibrate.py``).

The size crossovers that decide between collective methods are properties of
the link: one hop's latency L and its bandwidth bw, fitted from
``t(S) = L + S / bw`` over a size sweep (:func:`fit_latency_bandwidth`).
Their product, the bandwidth-delay product, is where a one-shot push stops
winning against a ring (``comm.allgather.choose_method``); twice it is the
AllReduce's one-shot vs two-shot crossover (``comm.allreduce.choose_method``).
A calibration persists as JSON at :func:`calibration_path`
(``TDT_LINKCAL_CACHE``, else ``~/.cache/triton_distributed_tpu_torch/
linkcal.json``), and every later process derives its thresholds from it;
without one the cold defaults hold (256 KiB, 512 KiB), the JAX package's.

The field names are JAX's: ``ici_*`` is the link between the cards of one
host (NVLink on an H100 host), ``dcn_*`` the network between hosts.  The
measurement itself (:func:`calibrate`) needs one process per card and waits
for the multi-card host (ROADMAP A11): ranks co-located on one card exchange
through its memory, not a link, so timing them would measure the wrong
thing.  With several processes (``torch.distributed``), the derived
thresholds are agreed across them (:func:`agree_thresholds`), since a
disagreement would launch mismatched collective kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os

# Cold-start crossovers: the JAX package's constants (``calibrate.py:44-45``).
DEFAULT_PUSH_BYTES = 256 * 1024
DEFAULT_ONE_SHOT_BYTES = 512 * 1024

# Cold-start wire rates of an H100 host, per card and per direction
# (NVIDIA's data sheets): NVLink 900 GB/s both ways, and one 400 Gb/s
# network port per card (DGX H100).
NVLINK_GBPS = 450.0
NETWORK_GBPS = 50.0


def calibration_path() -> str:
    return os.environ.get(
        "TDT_LINKCAL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "triton_distributed_tpu_torch", "linkcal.json"))


@dataclasses.dataclass(frozen=True)
class LinkCalibration:
    """Measured characteristics of each wire class (JAX ``:57-87``):
    per-card hop bandwidth and latency within a host (``ici_*``) and between
    hosts (``dcn_*``), the device kind and count, and the topology the
    hierarchical collectives' schedule reads (``num_slices`` hosts of
    ``chips_per_slice`` cards)."""

    ici_gbps: float | None = None
    ici_hop_us: float | None = None
    dcn_gbps: float | None = None
    dcn_hop_us: float | None = None
    device_kind: str = ""
    n_devices: int = 0
    num_slices: int = 1
    chips_per_slice: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "LinkCalibration":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


_cached: LinkCalibration | None = None
_cached_path: str | None = None
_agreed: tuple[int, int] | None = None


def load_calibration() -> LinkCalibration | None:
    """The persisted calibration, or None (cold start); cached per path, so
    a method choice pays a dict lookup, not a file read."""
    global _cached, _cached_path
    path = calibration_path()
    if _cached_path == path:
        return _cached
    try:
        with open(path) as f:
            _cached = LinkCalibration.from_json(json.load(f))
    except (OSError, ValueError, TypeError):
        _cached = None
    _cached_path = path
    return _cached


def save_calibration(cal: LinkCalibration) -> None:
    """Persist ``cal`` atomically; the derived thresholds agree anew."""
    global _cached, _cached_path, _agreed
    _agreed = None
    path = calibration_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cal.to_json(), f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _cached, _cached_path = cal, path


def invalidate_cache() -> None:
    """Drop the in-process cache (after another process re-calibrated)."""
    global _cached, _cached_path, _agreed
    _cached = _cached_path = None
    _agreed = None


def fit_latency_bandwidth(sizes_bytes, times_s) -> tuple[float, float]:
    """Least-squares fit of ``t(S) = L + S / bw`` -> (hop_us, gbps); a
    negative intercept (noise above the latency at the smallest size) clamps
    to 0."""
    import numpy as np

    s = np.asarray(sizes_bytes, np.float64)
    t = np.asarray(times_s, np.float64)
    if len(s) < 2 or len(s) != len(t):
        raise ValueError("need >= 2 (size, time) points")
    slope, intercept = np.polyfit(s, t, 1)
    if slope <= 0:
        raise ValueError(
            f"non-physical fit (slope {slope:g} s/byte <= 0): timing noise "
            f"exceeded the size effect; re-run with larger sizes")
    return max(intercept, 0.0) * 1e6, 1.0 / slope / 1e9


def calibrate(*args, **kwargs) -> LinkCalibration:
    """Measure the links (JAX ``:151-259``: a size-swept hop between
    neighbour cards, fitted by :func:`fit_latency_bandwidth`)."""
    raise NotImplementedError(
        "link calibration times a hop between two cards and needs one process per card: "
        "it comes with the multi-card host (ROADMAP A11); save a LinkCalibration with "
        "save_calibration meanwhile")


def _bdp_bytes(cal: LinkCalibration | None) -> float | None:
    """The bandwidth-delay product of the link within a host, at least 8 KiB
    (a measured latency of 0.0 is a calibration, not a cold start)."""
    if cal is None or not cal.ici_gbps or cal.ici_hop_us is None:
        return None
    return max(cal.ici_gbps * 1e9 * cal.ici_hop_us * 1e-6, 8192.0)


AGREE_REL_TOL = 0.05


def agree_thresholds(push_local: float, one_shot_local: float, *,
                     n_proc: int | None = None, mean_fn=None,
                     rel_tol: float = AGREE_REL_TOL) -> tuple[int, int]:
    """(push, one_shot) thresholds, identical on every process (JAX
    ``:289-328``): one process keeps its own; several take the mean across
    processes (``core.utils.process_mean``, a collective every process must
    reach) when the relative spread of each is within ``rel_tol``, else the
    cold defaults.  ``n_proc``/``mean_fn`` are for tests."""
    if n_proc is None:
        import torch.distributed as dist

        n_proc = (dist.get_world_size()
                  if dist.is_available() and dist.is_initialized() else 1)
    if n_proc == 1:
        return int(push_local), int(one_shot_local)
    if mean_fn is None:
        from ..core.utils import process_mean as mean_fn
    p, o = float(push_local), float(one_shot_local)
    mp, mo, mp2, mo2 = mean_fn([p, o, p * p, o * o])

    def rel_spread(m, m2) -> float:
        return (max(m2 - m * m, 0.0) ** 0.5) / m if m else 0.0

    if rel_spread(mp, mp2) > rel_tol or rel_spread(mo, mo2) > rel_tol:
        return DEFAULT_PUSH_BYTES, DEFAULT_ONE_SHOT_BYTES
    return int(round(mp)), int(round(mo))


def _thresholds() -> tuple[int, int]:
    """The local derivation, agreed across processes once (memoized)."""
    global _agreed
    if _agreed is not None:
        return _agreed
    bdp = _bdp_bytes(load_calibration())
    push = int(bdp) if bdp is not None else DEFAULT_PUSH_BYTES
    one = int(2 * bdp) if bdp is not None else DEFAULT_ONE_SHOT_BYTES
    _agreed = agree_thresholds(push, one)
    return _agreed


def wire_gbps(wire_class: str) -> float:
    """Per-card bandwidth of a wire class ("ici" within a host, "dcn"
    between hosts): the calibration's when it has one, else the card's
    published rates (:data:`NVLINK_GBPS`, :data:`NETWORK_GBPS`)."""
    cal = load_calibration()
    if wire_class == "dcn":
        if cal is not None and cal.dcn_gbps:
            return float(cal.dcn_gbps)
        return NETWORK_GBPS
    if cal is not None and cal.ici_gbps:
        return float(cal.ici_gbps)
    return NVLINK_GBPS


def codec_pays(wire_class: str, h: int = 7168, *, codec_gbps: float) -> bool:
    """Whether the fp8 wire message wins net time on ``wire_class`` at row
    width ``h`` (JAX ``:362-387``): the wire time its saved bytes would take
    must exceed the time the codec takes on the bf16 row.  ``codec_gbps``,
    the pack + unpack throughput, has no measurement on the card yet (K18's
    pack alone is in PERF.md), so the caller gives it."""
    from ..lang import quant

    saved_bytes = 2 * h - quant.packed_width(h, "fp8")
    if saved_bytes <= 0:
        return False
    codec_s = (2 * h) / (codec_gbps * 1e9)
    wire_s = saved_bytes / (wire_gbps(wire_class) * 1e9)
    return wire_s > codec_s


def push_bytes_threshold() -> int:
    """AllGather one-shot push vs ring crossover, in bytes per shard: the
    calibrated bandwidth-delay product, else 256 KiB."""
    return _thresholds()[0]


def one_shot_bytes_threshold() -> int:
    """AllReduce one-shot vs two-shot crossover, in bytes per rank: twice the
    calibrated bandwidth-delay product, else 512 KiB."""
    return _thresholds()[1]
