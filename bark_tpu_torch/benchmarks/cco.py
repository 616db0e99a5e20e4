"""Cellular Coverage-and-Capacity Optimization benchmark (CCOBench).

Copy of ``bark_tpu/benchmarks/cco.py`` (numpy only; held equal to it by
``tests/test_torch_benchmarks.py``).

Parity: src/bofire_mixed/benchmarks/cco/{cellular_network.py:20-138,
problem_formulation.py:17-99, simulated_rsrp.py:22-623}. The problem (from
Dreifuerst et al., ICASSP 2021): choose a downtilt (integer) and transmit
power (continuous, 30-50 dBm) for each of 15 sectors of a cellular network
to minimize ``0.5 * weak_coverage% + 0.5 * over_coverage%`` over a raster
of user locations, where

  weak coverage:  RSRP(x) < -80 dBm               (coverage holes)
  over coverage:  RSRP(x) >= -80 dBm and
                  interference(x) + 6 dB > RSRP(x) (cell-edge interference)

RSRP at a location is the strongest sector's received power; interference
is the watt-sum of all the others (floored at 1e-24 W).

Data: the reference drives this from 11 ray-traced powermap blobs
(``powermatrixDT{0..10}.npz`` — one map per integer downtilt) that are
absent from its own checkout (``.MISSING_LARGE_BLOBS:1-11``). Exactly like
SVRBench, this implementation loads real blobs when present (pass
``powermaps_path`` or drop them under ``benchmarks/data/cco_powermaps/``)
and otherwise *synthesizes* physically-plausible powermaps with a standard
3GPP-style sector antenna model (horizontal/vertical quadratic patterns,
UMa log-distance pathloss, smooth deterministic shadowing), so every code
path — downtilt interpolation, serving-cell selection, interference
aggregation, raster scoring — stays runnable and testable. The synthetic
maps keep the npz schema (``x``, ``y``, ``z``, ``ptx``, ``Tx{i}pwr``,
``Tx{i}loc``) so real blobs drop in with no code change.

Batched redesign notes: the reference evaluates one configuration at a
time through a Python loop over sectors with per-sector 2-D slicing
(simulated_rsrp.py:372-379); here the whole pipeline is one batched gather
+ reduction over a stacked ``(downtilts, X, Y, sectors)`` tensor, so a
candidate batch evaluates in a handful of numpy ops (the benchmark is a
host-side workload — the surrogate/acquisition side is what runs on the
accelerator).
"""

from __future__ import annotations

import pathlib

import numpy as np

from bark_tpu_torch.benchmarks.base import Benchmark, register_benchmark
from bark_tpu_torch.domain import ContinuousInput, Domain, build_integer_input

MIN_INTERFERENCE_POWER_WATT = 1e-24  # simulated_rsrp.py:19

_DATA_DIR = pathlib.Path(__file__).resolve().parent / "data" / "cco_powermaps"


def watt_to_dbm(x):
    return 10.0 * np.log10(x) + 30.0


def dbm_to_watt(x):
    return 10.0 ** (x / 10.0 - 3.0)


def synthetic_powermaps(
    seed: int = 0,
    grid_size: int = 81,
    extent: float = 2000.0,
    num_base_stations: int = 5,
    sectors_per_bs: int = 3,
    num_downtilts: int = 11,
) -> dict[int, dict[str, np.ndarray]]:
    """Generate npz-schema powermaps for integer downtilts 0..num_downtilts-1.

    Model (standard sectorized-macro abstractions):
      - base stations at the map center and at four offset sites, 25 m
        masts; three sectors per site at 120-degree azimuths;
      - UMa-like log-distance pathloss ``128.1 + 37.6 log10(d_km)``;
      - 3GPP parabolic antenna patterns: horizontal
        ``-min(12 (daz/65)^2, 30)`` dB, vertical
        ``-min(12 ((theta - downtilt)/10)^2, 30)`` dB against the boresight
        elevation, 18 dBi peak gain — downtilt steers the vertical beam,
        trading cell-edge coverage against near-cell interference, which is
        exactly the coverage/capacity tension the benchmark optimizes;
      - smooth deterministic "shadowing" (low-frequency sinusoidal field,
        ~3 dB RMS) so maps are not radially symmetric.

    Returns the same dict-of-arrays schema as the reference blobs
    (simulated_rsrp.py:513-572): received power at each raster point for a
    0 dBm-equivalent transmit power, stored as ``Tx{i}pwr + ptx_dBm`` with
    ``ptx`` in watt.
    """
    rng = np.random.default_rng(seed)
    coords = np.linspace(-extent, extent, grid_size)
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    ue_z = 1.5

    # site layout: center + ring, with a little deterministic jitter
    ring = np.stack(
        [
            np.cos(np.linspace(0, 2 * np.pi, num_base_stations - 1, False)),
            np.sin(np.linspace(0, 2 * np.pi, num_base_stations - 1, False)),
        ],
        axis=-1,
    )
    sites = np.vstack([[0.0, 0.0], 0.55 * extent * ring])
    sites = sites + rng.uniform(-0.05, 0.05, sites.shape) * extent
    bs_z = 25.0

    ptx_watt = 1.0  # 30 dBm reference transmit power
    ptx_dbm = watt_to_dbm(ptx_watt)

    # per-sector azimuths with a per-site offset
    az_offsets = rng.uniform(0.0, 360.0, num_base_stations)

    # smooth shadowing field per sector: sum of random plane-wave cosines
    def shadow(key):
        r = np.random.default_rng(key)
        field = np.zeros_like(gx)
        for _ in range(6):
            kx, ky = r.normal(0.0, 2.0 / extent, 2)
            phase = r.uniform(0.0, 2 * np.pi)
            field += r.normal(0.0, 1.5) * np.cos(kx * gx + ky * gy + phase)
        return field

    # downtilt-independent per-sector fields, computed once (only the
    # vertical pattern depends on the downtilt; r4 code review)
    base_pwr = []  # per site: (X, Y, sectors) at 0 downtilt-gain
    elevs = []
    for b in range(num_base_stations):
        bx, by = sites[b]
        dx, dy = gx - bx, gy - by
        d2d = np.sqrt(dx * dx + dy * dy)
        d3d = np.sqrt(d2d * d2d + (bs_z - ue_z) ** 2)
        pathloss = 128.1 + 37.6 * np.log10(np.maximum(d3d, 35.0) / 1000.0)
        # boresight elevation: angle below horizontal toward the UE
        elevs.append(np.degrees(np.arctan2(bs_z - ue_z, np.maximum(d2d, 1.0))))
        az_ue = np.degrees(np.arctan2(dy, dx))
        sec = []
        for s in range(sectors_per_bs):
            az_bore = az_offsets[b] + 360.0 * s / sectors_per_bs
            daz = (az_ue - az_bore + 180.0) % 360.0 - 180.0
            horiz = -np.minimum(12.0 * (daz / 65.0) ** 2, 30.0)
            sec.append(
                18.0 - pathloss + horiz + shadow(seed * 1000 + b * 10 + s)
            )
        base_pwr.append(np.stack(sec, axis=-1))

    maps: dict[int, dict[str, np.ndarray]] = {}
    for dt in range(num_downtilts):
        per_site_pwr = []
        for b in range(num_base_stations):
            vert = -np.minimum(12.0 * ((elevs[b] - dt) / 10.0) ** 2, 30.0)
            per_site_pwr.append(
                (base_pwr[b] + vert[..., None]).astype(np.float32)
            )
        maps[dt] = {
            "x": coords.astype(np.float64),
            "y": coords.astype(np.float64),
            "z": np.float64(ue_z),
            "ptx": np.float64(ptx_watt),
            **{
                f"Tx{b + 1}pwr": per_site_pwr[b] + np.float32(ptx_dbm)
                for b in range(num_base_stations)
            },
            **{
                f"Tx{b + 1}loc": np.array([*sites[b], bs_z])
                for b in range(num_base_stations)
            },
        }
    return maps


class RSRPSimulator:
    """Batched RSRP/interference maps from per-downtilt power matrices.

    Parity: simulated_rsrp.py:22-623, redesigned: the per-downtilt maps are
    stacked into one ``(num_downtilts, X, Y, S)`` tensor at construction;
    ``powermaps`` evaluates a whole (B, S) configuration batch with two
    gathers (floor/ceil downtilt), one lerp, and max/sum reductions — no
    per-sector Python loop (reference: simulated_rsrp.py:372-379), and
    fractional downtilts get the same linear interpolation
    (simulated_rsrp.py:428-458).
    """

    def __init__(
        self,
        powermaps: dict[int, dict[str, np.ndarray]],
        min_tx_power_dbm: float = 30.0,
        max_tx_power_dbm: float = 50.0,
    ):
        keys = sorted(powermaps.keys())
        if keys != list(range(len(keys))):
            raise ValueError("powermaps must be keyed by downtilts 0..D-1")
        stacked = []
        locs = None
        for k in keys:
            data = powermaps[k]
            ptx_dbm = watt_to_dbm(np.asarray(data["ptx"], np.float64))
            n_bs = max(
                int(name[2:-3]) for name in data if name.endswith("pwr")
            )
            pwr = np.concatenate(
                [
                    np.asarray(data[f"Tx{b + 1}pwr"], np.float32) - ptx_dbm
                    for b in range(n_bs)
                ],
                axis=-1,
            )  # (X, Y, S) received power at 0 dBm TX
            stacked.append(pwr)
            locs = np.stack(
                [np.asarray(data[f"Tx{b + 1}loc"]) for b in range(n_bs)]
            )
            self.x = np.asarray(data["x"], np.float64)
            self.y = np.asarray(data["y"], np.float64)
        self.power = np.stack(stacked)  # (D, X, Y, S)
        self.base_station_locations = locs
        self.num_downtilts = self.power.shape[0]
        self.num_total_sectors = self.power.shape[-1]
        self.min_tx_power_dbm = float(min_tx_power_dbm)
        self.max_tx_power_dbm = float(max_tx_power_dbm)

    def powermaps(
        self, downtilts: np.ndarray, tx_powers: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(B, S) configurations -> (rsrp, interference, serving) maps.

        Returns ``(B, X, Y)`` RSRP dBm, interference dBm, and serving-sector
        index arrays (parity: simulated_rsrp.py:345-399, batched).
        """
        downtilts = np.atleast_2d(np.asarray(downtilts, np.float64))
        tx_powers = np.atleast_2d(np.asarray(tx_powers, np.float64))
        if downtilts.shape != tx_powers.shape or (
            downtilts.shape[1] != self.num_total_sectors
        ):
            raise ValueError("configuration shape must be (B, num_sectors)")
        if downtilts.min() < 0 or downtilts.max() > self.num_downtilts - 1:
            raise ValueError("downtilt is out of the range")
        if (
            tx_powers.max() > self.max_tx_power_dbm
            or tx_powers.min() < self.min_tx_power_dbm
        ):
            raise ValueError("Transmit Power is out of the range")

        lo = np.floor(downtilts).astype(np.int64)
        hi = np.minimum(lo + 1, self.num_downtilts - 1)
        w = (downtilts - lo).astype(np.float32)
        # per-sector gather over the downtilt axis: (D, X, Y, S) -> (B, S, X, Y)
        per_sector = np.moveaxis(self.power, -1, 1)  # (D, S, X, Y)
        s_idx = np.arange(self.num_total_sectors)
        pm = (1.0 - w)[..., None, None] * per_sector[lo, s_idx] + w[
            ..., None, None
        ] * per_sector[hi, s_idx]
        rx = pm + tx_powers[..., None, None].astype(np.float32)  # (B,S,X,Y)

        rsrp = rx.max(axis=1)  # (B, X, Y)
        serving = rx.argmax(axis=1)
        interference_watt = np.maximum(
            MIN_INTERFERENCE_POWER_WATT,
            dbm_to_watt(rx).sum(axis=1) - dbm_to_watt(rsrp),
        )
        return rsrp, watt_to_dbm(interference_watt), serving


class CCORasterFormulation:
    """Weak/over-coverage raster scoring (problem_formulation.py:17-99)."""

    def __init__(
        self,
        weak_coverage_threshold: float = -80.0,
        over_coverage_threshold: float = 6.0,
    ):
        self.weak_coverage_threshold = weak_coverage_threshold
        self.over_coverage_threshold = over_coverage_threshold

    def coverage_areas(self, rsrp, interference):
        weak = rsrp < self.weak_coverage_threshold
        over = (rsrp >= self.weak_coverage_threshold) & (
            interference + self.over_coverage_threshold > rsrp
        )
        return weak, over

    def area_percentages(self, rsrp, interference):
        """Per-config (weak%, over%) over the raster — batched over leading
        dims (parity: problem_formulation.py:65-78)."""
        weak, over = self.coverage_areas(rsrp, interference)
        size = rsrp.shape[-1] * rsrp.shape[-2]
        return (
            weak.sum(axis=(-2, -1)) / size,
            over.sum(axis=(-2, -1)) / size,
        )

    def reward_components(self, rsrp, interference):
        """Sigmoid-soft severity sums (parity: problem_formulation.py:42-63)."""
        weak, over = self.coverage_areas(rsrp, interference)
        sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
        f_weak = (sig(self.weak_coverage_threshold - rsrp) * weak).sum(
            axis=(-2, -1)
        )
        g_over = (
            sig(interference + self.over_coverage_threshold - rsrp) * over
        ).sum(axis=(-2, -1))
        return f_weak, g_over


def _load_powermaps(powermaps_path, seed: int) -> tuple[dict[int, dict], str]:
    """Real blobs when available, synthetic otherwise (the SVRBench rule)."""
    path = pathlib.Path(powermaps_path) if powermaps_path else _DATA_DIR
    files = sorted(path.glob("powermatrixDT*.npz")) if path.is_dir() else []
    if files:
        data = {}
        for f in files:
            dt = int(f.stem.replace("powermatrixDT", ""))
            data[dt] = dict(np.load(f))
        return data, f"real powermaps from {path}"
    if powermaps_path:
        raise FileNotFoundError(
            f"no powermatrixDT*.npz files under {powermaps_path}"
        )
    return (
        synthetic_powermaps(seed=seed),
        f"synthetic powermaps (no blobs found; seed={seed})",
    )


@register_benchmark("CCOBench")
class CCOBench(Benchmark):
    """Coverage/capacity optimization over 15 downtilts + 15 TX powers.

    Parity: cellular_network.py:20-138 — identical domain (15 integer
    downtilt inputs, 15 continuous power inputs in [30, 50] dBm), identical
    objective ``0.5 * weak% + 0.5 * over%`` (minimized), identical 6-value
    downtilt rescaling (ordinal 0..5 -> physical 0,2,..,10).
    """

    def __init__(
        self, n_int_values: int = 6, powermaps_path=None, seed: int = 0
    ):
        if n_int_values not in (6, 11):
            raise ValueError("Only 6 and 11 int values are supported")
        self.n_int_values = n_int_values
        # seed varies the synthetic network realization (site jitter,
        # azimuths, shadowing) — multi-seed studies get distinct problem
        # instances; ignored when real blobs are present
        data, self.data_source = _load_powermaps(powermaps_path, seed)
        self.simulator = RSRPSimulator(data)
        self.formulation = CCORasterFormulation()
        num_sectors = self.simulator.num_total_sectors
        super().__init__(
            Domain(
                [
                    *[
                        build_integer_input(
                            key=f"downtilt_{i}", bounds=(0, n_int_values - 1)
                        )
                        for i in range(num_sectors)
                    ],
                    *[
                        ContinuousInput(f"power_{i}", (30.0, 50.0))
                        for i in range(num_sectors)
                    ],
                ]
            )
        )

    def _f(self, X: np.ndarray) -> np.ndarray:
        s = self.simulator.num_total_sectors
        downtilts = X[:, :s].astype(np.float64)
        tx_powers = X[:, s : 2 * s].astype(np.float64)
        if self.n_int_values == 6:
            downtilts = downtilts * 2  # cellular_network.py:109-110
        rsrp, interference, _ = self.simulator.powermaps(downtilts, tx_powers)
        weak, over = self.formulation.area_percentages(rsrp, interference)
        return 0.5 * weak + 0.5 * over
