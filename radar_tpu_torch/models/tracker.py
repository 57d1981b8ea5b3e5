"""Multi-frame object tracker over per-frame detection lists (the port's
copy of ``radar_tpu.models.tracker``, held to it by the tests).

Turns the RD pipeline's per-frame detection lists into persistent object
tracks:

* gated nearest-neighbor association in (range, velocity, azimuth),
* alpha-beta filtering of range (velocity is measured directly by Doppler,
  so it seeds and corrects the rate term),
* M-hit confirmation and coast/delete lifecycle,

or, with :class:`EKFTracker`, a Cartesian constant-velocity EKF.

Deliberately host-side NumPy in float64: tracking is branchy, per-object
control flow over a handful of detections — the wrong shape for the
GPU's wide launches, and it consumes only the tiny detection records the
device pipeline emits (:func:`materialize_result` brings them over in
one transfer per field).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from radar_tpu_torch.config import RadarConfig, DEFAULT_CONFIG


@dataclasses.dataclass
class Track:
    track_id: int
    range_m: float
    velocity_mps: float
    azimuth_deg: float
    power: float
    hits: int = 1
    misses: int = 0
    confirmed: bool = False
    history: list = dataclasses.field(default_factory=list)

    def predict(self, dt: float) -> float:
        """Predicted range after dt seconds."""
        return self.range_m + self.velocity_mps * dt


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    gate_range_m: float = 1.5
    gate_velocity_mps: float = 2.5
    gate_azimuth_deg: float = 20.0
    alpha: float = 0.6          # range correction gain
    beta: float = 0.3           # velocity correction gain
    azimuth_smoothing: float = 0.5
    # M-hit confirmation.  3 (round 5; was 2): with the Erlang-matched
    # default CFAR alpha the detector runs at its DESIGN Pfa (the legacy
    # exponential alpha realized ~0 false alarms), so 2-hit confirmation
    # lets a false-alarm pair — or a flickering quenched base-noise cell
    # (see MIGRATION.md round-5 notes) — spawn a confirmed ghost track;
    # 3-of-N is the classic radar confirmation logic for a calibrated
    # detector.
    confirm_hits: int = 3
    max_misses: int = 3


class Tracker:
    """Feed per-frame detection lists; read back confirmed tracks."""

    def __init__(
        self,
        cfg: RadarConfig = DEFAULT_CONFIG,
        params: TrackerConfig = TrackerConfig(),
    ):
        self.cfg = cfg
        self.params = params
        self.frame_interval_s = cfg.num_chirps * cfg.chirp_interval_s
        self.tracks: list[Track] = []
        self._ids = itertools.count()

    # -- association ---------------------------------------------------------
    def _distance(self, track: Track, det: dict, dt: float) -> float | None:
        p = self.params
        dr = abs(det["range_m"] - track.predict(dt))
        dv = abs(det["velocity_mps"] - track.velocity_mps)
        da = abs(det["azimuth_deg"] - track.azimuth_deg)
        if dr > p.gate_range_m or dv > p.gate_velocity_mps or da > p.gate_azimuth_deg:
            return None
        return (
            (dr / p.gate_range_m) ** 2
            + (dv / p.gate_velocity_mps) ** 2
            + (da / p.gate_azimuth_deg) ** 2
        )

    def update(self, detections: list[dict], dt: float | None = None) -> list[Track]:
        """Advance one frame.

        Args:
          detections: dicts with range_m / velocity_mps / azimuth_deg /
            power (the RD pipeline's valid top-K entries).
          dt: seconds since the previous frame (default: one frame).

        Returns:
          currently confirmed tracks.
        """
        p = self.params
        dt = self.frame_interval_s if dt is None else dt

        # greedy gated nearest-neighbor (few objects; optimality irrelevant)
        pairs = []
        for ti, tr in enumerate(self.tracks):
            for di, det in enumerate(detections):
                d = self._distance(tr, det, dt)
                if d is not None:
                    pairs.append((d, ti, di))
        pairs.sort(key=lambda x: x[0])
        used_t, used_d = set(), set()
        for _, ti, di in pairs:
            if ti in used_t or di in used_d:
                continue
            used_t.add(ti)
            used_d.add(di)
            tr, det = self.tracks[ti], detections[di]
            pred = tr.predict(dt)
            residual = det["range_m"] - pred
            tr.range_m = pred + p.alpha * residual
            # velocity is MEASURED directly by Doppler; do not differentiate
            # the bin-quantized range (residual/dt would amplify the 0.39 m
            # range quantization into tens of m/s at radar frame rates)
            tr.velocity_mps = (
                (1 - p.beta) * tr.velocity_mps + p.beta * det["velocity_mps"]
            )
            s = p.azimuth_smoothing
            tr.azimuth_deg = (1 - s) * tr.azimuth_deg + s * det["azimuth_deg"]
            tr.power = det.get("power", tr.power)
            tr.hits += 1
            tr.misses = 0
            if tr.hits >= p.confirm_hits:
                tr.confirmed = True
            tr.history.append((tr.range_m, tr.velocity_mps, tr.azimuth_deg))

        # coast / delete unmatched tracks
        survivors = []
        for ti, tr in enumerate(self.tracks):
            if ti in used_t:
                survivors.append(tr)
                continue
            tr.misses += 1
            tr.range_m = tr.predict(dt)
            if tr.misses <= p.max_misses:
                survivors.append(tr)
        self.tracks = survivors

        # spawn tentative tracks from unmatched detections
        for di, det in enumerate(detections):
            if di in used_d:
                continue
            self.tracks.append(
                Track(
                    track_id=next(self._ids),
                    range_m=det["range_m"],
                    velocity_mps=det["velocity_mps"],
                    azimuth_deg=det["azimuth_deg"],
                    power=det.get("power", 0.0),
                    history=[(det["range_m"], det["velocity_mps"],
                              det["azimuth_deg"])],
                )
            )
        return [t for t in self.tracks if t.confirmed]


# --------------------------------------------------------------------------
# Extended Kalman tracker (Cartesian constant-velocity model)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EKFConfig:
    """Noise/gating parameters for :class:`EKFTracker`.

    Measurement sigmas default to the pipeline's quantization: ~0.39 m
    range bins, ~0.24 m/s Doppler bins, angle-FFT ~4 deg at boresight.
    """

    sigma_range_m: float = 0.4
    sigma_velocity_mps: float = 0.25
    sigma_azimuth_deg: float = 4.0
    accel_std_mps2: float = 4.0        # white-acceleration process noise
    init_tangential_vel_std: float = 8.0
    gate_mahalanobis: float = 11.34    # chi-square 3 dof, 99%
    # M-hit confirmation.  3 (round 5; was 2): with the Erlang-matched
    # default CFAR alpha the detector runs at its DESIGN Pfa (the legacy
    # exponential alpha realized ~0 false alarms), so 2-hit confirmation
    # lets a false-alarm pair — or a flickering quenched base-noise cell
    # (see MIGRATION.md round-5 notes) — spawn a confirmed ghost track;
    # 3-of-N is the classic radar confirmation logic for a calibrated
    # detector.
    confirm_hits: int = 3
    max_misses: int = 3


@dataclasses.dataclass
class EKFTrack:
    """Cartesian CV track: state [x, y, vx, vy] (x cross-range, y down-range)."""

    track_id: int
    state: np.ndarray
    cov: np.ndarray
    power: float
    hits: int = 1
    misses: int = 0
    confirmed: bool = False
    history: list = dataclasses.field(default_factory=list)

    @property
    def range_m(self) -> float:
        return float(np.hypot(self.state[0], self.state[1]))

    @property
    def velocity_mps(self) -> float:
        """Radial velocity (positive = receding), matching detections."""
        r = max(self.range_m, 1e-6)
        return float(
            (self.state[0] * self.state[2] + self.state[1] * self.state[3]) / r
        )

    @property
    def azimuth_deg(self) -> float:
        return float(np.rad2deg(np.arctan2(self.state[0], self.state[1])))

    @property
    def speed_mps(self) -> float:
        """Full (vector) ground speed — the EKF observable alpha-beta lacks."""
        return float(np.hypot(self.state[2], self.state[3]))


def _ekf_h(state: np.ndarray) -> np.ndarray:
    x, y, vx, vy = state
    r = max(np.hypot(x, y), 1e-6)
    return np.array([r, (x * vx + y * vy) / r, np.arctan2(x, y)])


def _ekf_jacobian(state: np.ndarray) -> np.ndarray:
    x, y, vx, vy = state
    r = max(np.hypot(x, y), 1e-6)
    rdot = (x * vx + y * vy) / r
    return np.array([
        [x / r, y / r, 0.0, 0.0],
        [vx / r - x * rdot / r**2, vy / r - y * rdot / r**2, x / r, y / r],
        [y / r**2, -x / r**2, 0.0, 0.0],
    ])


class EKFTracker:
    """EKF multi-object tracker over (range, Doppler, azimuth) detections.

    Upgrades the alpha-beta :class:`Tracker` with a Cartesian
    constant-velocity motion model: a crossing target (tangential motion,
    near-zero Doppler, swinging azimuth) is a straight line in this state
    space, where the polar alpha-beta filter sees three uncoupled changing
    channels.  Association gates on the Mahalanobis distance of the full
    innovation (range + radial velocity + azimuth, with the azimuth
    residual wrapped), so gating tightens automatically as a track's
    covariance converges.  Same ``update`` API and confirmed-track
    interface as :class:`Tracker`.
    """

    def __init__(
        self,
        cfg: RadarConfig = DEFAULT_CONFIG,
        params: EKFConfig = EKFConfig(),
    ):
        self.cfg = cfg
        self.params = params
        self.frame_interval_s = cfg.num_chirps * cfg.chirp_interval_s
        self.tracks: list[EKFTrack] = []
        self._ids = itertools.count()
        p = params
        self._r_mat = np.diag([
            p.sigma_range_m**2,
            p.sigma_velocity_mps**2,
            np.deg2rad(p.sigma_azimuth_deg) ** 2,
        ])

    def _predict_mats(self, dt: float):
        f = np.eye(4)
        f[0, 2] = f[1, 3] = dt
        q = self.params.accel_std_mps2**2
        q4, q3, q2 = q * dt**4 / 4, q * dt**3 / 2, q * dt**2
        qm = np.array([
            [q4, 0, q3, 0],
            [0, q4, 0, q3],
            [q3, 0, q2, 0],
            [0, q3, 0, q2],
        ])
        return f, qm

    @staticmethod
    def _measurement(det: dict) -> np.ndarray:
        return np.array([
            det["range_m"],
            det["velocity_mps"],
            np.deg2rad(det["azimuth_deg"]),
        ])

    def _innovation(self, tr: EKFTrack, z: np.ndarray):
        h = _ekf_jacobian(tr.state)
        y = z - _ekf_h(tr.state)
        y[2] = (y[2] + np.pi) % (2 * np.pi) - np.pi  # wrap azimuth residual
        s = h @ tr.cov @ h.T + self._r_mat
        return y, h, s

    def update(self, detections: list[dict], dt: float | None = None) -> list[EKFTrack]:
        """Advance one frame; returns currently confirmed tracks."""
        p = self.params
        dt = self.frame_interval_s if dt is None else dt
        f, qm = self._predict_mats(dt)
        for tr in self.tracks:
            tr.state = f @ tr.state
            tr.cov = f @ tr.cov @ f.T + qm

        # gated greedy nearest-neighbor on Mahalanobis distance
        pairs = []
        cache = {}
        for ti, tr in enumerate(self.tracks):
            for di, det in enumerate(detections):
                y, h, s = self._innovation(tr, self._measurement(det))
                d2 = float(y @ np.linalg.solve(s, y))
                if d2 <= p.gate_mahalanobis:
                    pairs.append((d2, ti, di))
                    cache[(ti, di)] = (y, h, s)
        pairs.sort(key=lambda x: x[0])
        used_t, used_d = set(), set()
        for _, ti, di in pairs:
            if ti in used_t or di in used_d:
                continue
            used_t.add(ti)
            used_d.add(di)
            tr = self.tracks[ti]
            y, h, s = cache[(ti, di)]
            k = tr.cov @ h.T @ np.linalg.inv(s)
            tr.state = tr.state + k @ y
            ikh = np.eye(4) - k @ h
            # Joseph form: keeps the covariance PSD under roundoff
            tr.cov = ikh @ tr.cov @ ikh.T + k @ self._r_mat @ k.T
            tr.power = detections[di].get("power", tr.power)
            tr.hits += 1
            tr.misses = 0
            if tr.hits >= p.confirm_hits:
                tr.confirmed = True
            tr.history.append((tr.range_m, tr.velocity_mps, tr.azimuth_deg))

        survivors = []
        for ti, tr in enumerate(self.tracks):
            if ti in used_t:
                survivors.append(tr)
                continue
            tr.misses += 1  # state already coasted by the predict step
            if tr.misses <= p.max_misses:
                survivors.append(tr)
        self.tracks = survivors

        for di, det in enumerate(detections):
            if di in used_d:
                continue
            r, vr = det["range_m"], det["velocity_mps"]
            az = np.deg2rad(det["azimuth_deg"])
            sa, ca = np.sin(az), np.cos(az)
            state = np.array([r * sa, r * ca, vr * sa, vr * ca])
            pos_var = p.sigma_range_m**2 + (r * np.deg2rad(p.sigma_azimuth_deg)) ** 2
            vel_var = p.sigma_velocity_mps**2 + p.init_tangential_vel_std**2
            self.tracks.append(
                EKFTrack(
                    track_id=next(self._ids),
                    state=state,
                    cov=np.diag([pos_var, pos_var, vel_var, vel_var]),
                    power=det.get("power", 0.0),
                    history=[(r, vr, det["azimuth_deg"])],
                )
            )
        return [t for t in self.tracks if t.confirmed]


def materialize_result(rd_result):
    """Bulk device->host transfer of a batched RDResult: the same
    NamedTuple with NumPy leaves, one ``.cpu()`` transfer per leaf
    instead of one per scalar (a per-element ``float(...)`` loop would
    synchronise the device once per detection).  NumPy leaves pass
    through."""
    return type(rd_result)(*(
        leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
        else np.asarray(leaf)
        for leaf in rd_result
    ))


def group_peaks(
    detections: list[dict],
    range_window_m: float = 1.2,
    velocity_window_mps: float = 0.8,
    azimuth_window_deg: float = 12.0,
) -> list[dict]:
    """Peak grouping: collapse CFAR cell clusters to their strongest cell.

    A real target trips several adjacent range-Doppler cells (mainlobe +
    window leakage); tracking every cell spawns one track per sidelobe.
    Greedy strongest-first suppression within a (range, velocity, azimuth)
    window is the standard radar "peak grouping" step.  The azimuth window
    keeps two real targets at the same range/speed but different bearings
    (side-by-side objects) as separate detections — a target's own sidelobe
    cells share its azimuth, so they still collapse.

    This is the cheap host-side heuristic used on the latency-critical
    serve path (it needs only the packed detection list, no maps).  The
    exact map-topology version — connected components of the CFAR hit
    map with centroids and extents — is ``ops.cluster`` via
    ``RDPipeline.detect_objects`` / ``cli detect --cluster``.
    """
    kept: list[dict] = []
    for d in sorted(detections, key=lambda x: -x.get("power", 0.0)):
        clustered = any(
            abs(d["range_m"] - k["range_m"]) <= range_window_m
            and abs(d["velocity_mps"] - k["velocity_mps"]) <= velocity_window_mps
            and abs(d.get("azimuth_deg", 0.0) - k.get("azimuth_deg", 0.0))
            <= azimuth_window_deg
            for k in kept
        )
        if not clustered:
            kept.append(d)
    return kept


def detections_from_result(rd_result, frame: int, group: bool = True) -> list[dict]:
    """Extract frame ``frame``'s valid detections from a batched RDResult.

    Pass a :func:`materialize_result`-ed result when calling in a loop.
    """
    rd_result = materialize_result(rd_result)
    out = []
    valid = rd_result.valid[frame]
    for k in range(valid.shape[0]):
        if valid[k]:
            out.append(
                {
                    "range_m": float(rd_result.range_m[frame, k]),
                    "velocity_mps": float(rd_result.velocity_mps[frame, k]),
                    "azimuth_deg": float(rd_result.azimuth_deg[frame, k]),
                    "power": float(rd_result.power[frame, k]),
                }
            )
    return group_peaks(out) if group else out


def track_capture(rd_result, cfg: RadarConfig = DEFAULT_CONFIG,
                  params: TrackerConfig | EKFConfig | None = None,
                  kind: str = "alpha-beta"):
    """Run a tracker over a whole batched RDResult; returns the tracker.

    Args:
      kind: 'alpha-beta' (polar, measured-Doppler rate) or 'ekf'
        (Cartesian constant-velocity EKF — tracks crossing targets).
    """
    if kind not in ("alpha-beta", "ekf"):
        raise ValueError(
            f"tracker kind must be 'alpha-beta' or 'ekf', got {kind!r}"
        )
    want_cls = EKFConfig if kind == "ekf" else TrackerConfig
    if params is not None and not isinstance(params, want_cls):
        raise ValueError(
            f"params for kind={kind!r} must be {want_cls.__name__}, "
            f"got {type(params).__name__}"
        )
    rd_result = materialize_result(rd_result)
    if kind == "ekf":
        tracker = EKFTracker(cfg, params or EKFConfig())
    else:
        tracker = Tracker(cfg, params or TrackerConfig())
    n = rd_result.num_hits.shape[0]
    for f in range(n):
        tracker.update(detections_from_result(rd_result, f))
    return tracker
