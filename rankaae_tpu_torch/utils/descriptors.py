"""Offline spectral-descriptor extraction (the tool that produced the
``AUX_*`` CSV columns): the port's own copy of
``rankaae_tpu/utils/descriptors.py``, numpy and scipy only, unchanged but
for this paragraph (``tests/test_torch_descriptors.py`` holds the two
equal).

This is an original design, not a port: the behavioral contract — which
physical features are extracted and the numeric thresholds that define them —
comes from the reference (``sc/utils/descriptors.py:12-360``), but the
implementation is organized as

* a :class:`SpectrumView` value object holding the spectrum together with its
  precomputed derivatives (spline-analytic when available),
* a functional core of pure feature extractors
  (:func:`edge_descriptor`, :func:`main_peak_descriptor`, ...) that take a
  view plus previously-extracted anchor positions and return plain dicts,
* one orchestrator, :func:`extract_descriptors`, that runs them in dependency
  order (edge -> main peak -> pit -> secondary/last peaks -> derived scalars),
* a batch API, :func:`extract_descriptors_batch`, for whole (N, L) spectrum
  matrices — the workflow the reference forces through one object per row,
* a thin :class:`SpecDescriptors` wrapper kept only for API compatibility
  with reference-style notebooks (``.find_*()`` + ``.as_dict()``).

The reference's external ``pyfitit`` dependency (hardcoded user sys.path,
reference ``descriptors.py:7-8``) is replaced by a scipy ``curve_fit`` arctan
edge fit.  Not on the training path — a preprocessing utility.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
from numpy.polynomial import Polynomial
from scipy.interpolate import UnivariateSpline
from scipy.optimize import curve_fit
from scipy.signal import find_peaks

# --------------------------------------------------------------------------- #
# Behavioral spec constants, distilled from the reference implementation.
# These numbers ARE the descriptor definitions (changing them changes what
# "main peak" etc. mean), so they are kept verbatim and named.
# --------------------------------------------------------------------------- #

#: candidate main peaks must reach this absolute height (reference main-peak rule)
MAIN_PEAK_MIN_HEIGHT = 1.0
#: a later candidate replaces the leftmost one only if taller by this margin
MAIN_PEAK_TALLER_BY = 0.2
#: quadratic-refinement window widths (eV) per feature
REFINE_WINDOW = {"main_peak": 4.0, "pit": 16.0, "last_peak": 6.0}
#: the pit is searched this far (eV) to the right of the edge
PIT_SEARCH_OFFSET = 20.0
#: last peak: minimum prominence of candidates right of the pit
LAST_PEAK_PROMINENCE = 0.01
#: secondary peak: band [main + 5, pit - 2] eV, -d2 prominence threshold
SEC_PEAK_BAND = (5.0, 2.0)
SEC_PEAK_PROMINENCE = 0.003
#: pre-edge peak: band [grid start + 3, edge - 1]; curvature fallback band
#: right limit edge - 3
PRE_PEAK_LEFT_OFFSET = 3.0
PRE_PEAK_RIGHT_MARGIN = 1.0
PRE_PEAK_FALLBACK_RIGHT_MARGIN = 3.0
#: windowed-intensity readouts average the spectrum over this width (eV)
INTENSITY_WINDOW = 1.0
#: ``intensity_at_energy`` treats energies below this as edge-relative offsets
RELATIVE_ENERGY_MAX = 100.0


# --------------------------------------------------------------------------- #
# spectrum view
# --------------------------------------------------------------------------- #


class SpectrumView(NamedTuple):
    """A spectrum on a (fine) energy grid with precomputed derivatives.

    ``d1``/``d2`` are spline-analytic when a spline is supplied, else
    ``np.gradient`` with respect to the grid.
    """

    grid: np.ndarray
    spec: np.ndarray
    d1: np.ndarray
    d2: np.ndarray

    @classmethod
    def build(cls, grid, spec, spline: Optional[UnivariateSpline] = None):
        grid = np.asarray(grid, float)
        spec = np.asarray(spec, float)
        if spline is not None:
            d1 = spline.derivative(1)(grid)
            d2 = spline.derivative(2)(grid)
        else:
            d1 = np.gradient(spec, grid)
            d2 = np.gradient(d1, grid)
        return cls(grid=grid, spec=spec, d1=d1, d2=d2)

    @classmethod
    def from_spline(cls, coarse_grid, coarse_spec, *, fine_grid, k=5, s=0.01):
        """Spline-fit a coarse spectrum and view it on ``fine_grid``."""
        spl = UnivariateSpline(coarse_grid, coarse_spec, k=k, s=s)
        return cls.build(fine_grid, spl(fine_grid), spline=spl), spl

    @property
    def step(self) -> float:
        return float(self.grid[1] - self.grid[0])

    def nearest(self, position: float) -> int:
        return int(np.argmin(np.abs(self.grid - position)))

    def window_mean(self, center: float, width: float = INTENSITY_WINDOW) -> float:
        m = (self.grid >= center - width / 2) & (self.grid < center + width / 2)
        return float(self.spec[m].mean())


# --------------------------------------------------------------------------- #
# low-level search / refinement
# --------------------------------------------------------------------------- #


def _candidates(
    view: SpectrumView,
    *,
    signal: str = "spec",        # "spec" | "-spec" | "-d2"
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    min_height: Optional[float] = 0.0,
    min_prominence: float = 0.0,
    max_prominence: Optional[float] = None,
    min_width: float = 0.0,
    max_width: Optional[float] = None,
) -> np.ndarray:
    """Indices (into the grid) of local maxima of the chosen signal inside
    [lo, hi], sorted by position.  Both width bounds are in grid (energy)
    units and are converted to find_peaks samples via ``view.step``, exactly
    as the reference's ``_peaks`` does (``descriptors.py``: ``width[i] /
    (grid[1]-grid[0])``); prominence bounds are raw intensity units,
    forwarded as a (min, max) pair.

    ``min_height=0`` is the spec's default (reference ``find_peak_in_range``,
    ``descriptors.py:326``): on "-spec"/"-d2" signals it admits only
    non-positive spectrum / concave-curvature points, which is what makes
    the reference's pit search always fall back to the region argmin on
    positive XANES spectra.
    """
    y = {"spec": view.spec, "-spec": -view.spec, "-d2": -view.d2}[signal]
    width = (min_width / view.step,
             None if max_width is None else max_width / view.step)
    prominence = (min_prominence, max_prominence)
    idx, props = find_peaks(y, height=min_height, prominence=prominence,
                            width=width)
    keep = np.ones(len(idx), bool)
    if lo is not None:
        keep &= view.grid[idx] >= lo
    if hi is not None:
        keep &= view.grid[idx] <= hi
    if max_width is not None:
        keep &= props["widths"] < width[1]
    return idx[keep]


def refine_extremum(view: SpectrumView, center: float, width: float,
                    kind: str) -> Dict[str, float]:
    """Quadratic fit in a window around ``center``; returns the position and
    raw intensity at the fit's extremum sample plus the local |2nd difference|
    there (sample-spaced, matching the original extraction tool)."""
    m = (view.grid >= center - width / 2) & (view.grid < center + width / 2)
    g, y = view.grid[m], view.spec[m]
    fit = Polynomial.fit(g, y, 2)(g)
    i = int(np.argmax(fit) if kind == "max" else np.argmin(fit))
    local_d2 = np.gradient(np.gradient(y))
    return {"position": float(g[i]), "intensity": float(y[i]),
            "curvature": float(abs(local_d2[i]))}


def _mean_abs_d2(view: SpectrumView, mask) -> float:
    """|mean(d2)| over a region — the reference's roughness readout (note:
    absolute value OF the mean, a faithful quirk of the original tool)."""
    return float(np.abs(view.d2[mask].mean()))


# --------------------------------------------------------------------------- #
# edge fit
# --------------------------------------------------------------------------- #


def _arctan_step(x, x0, w, a, b):
    return a * (np.arctan((x - x0) / w) / np.pi + 0.5) + b


def fit_edge_arctan(grid: np.ndarray, spec: np.ndarray):
    """Fit an arctan step to the absorption edge; returns (x0, fitted curve).

    Pure-scipy replacement for pyfitit ``findEfermiByArcTan`` (reference
    ``descriptors.py:66``); falls back to the steepest-gradient guess when the
    fit does not converge.
    """
    grid = np.asarray(grid, float)
    spec = np.asarray(spec, float)
    p0 = [
        float(grid[int(np.argmax(np.gradient(spec)))]),
        float(grid[-1] - grid[0]) / 20,
        float(spec.max() - spec.min()),
        float(spec.min()),
    ]
    try:
        popt, _ = curve_fit(_arctan_step, grid, spec, p0=p0, maxfev=5000)
    except RuntimeError:
        popt = p0
    return float(popt[0]), _arctan_step(grid, *popt)


# --------------------------------------------------------------------------- #
# feature extractors (pure: view [+ anchors] -> dict)
# --------------------------------------------------------------------------- #


def edge_descriptor(view: SpectrumView):
    x0, fitted = fit_edge_arctan(view.grid, view.spec)
    i = view.nearest(x0)
    return {
        "position": float(view.grid[i]),
        "slope": float(view.d1[i]),
        "intensity": float(view.spec[i]),
    }, fitted


def main_peak_descriptor(view: SpectrumView, lo=None, hi=None,
                         min_prominence: float = 0.0, max_prominence=None,
                         min_width: float = 0.0, max_width=None,
                         intensity_window=None):
    """The white line: leftmost tall peak, unless a later one is taller by
    more than :data:`MAIN_PEAK_TALLER_BY`; curvature-valley fallback when no
    candidate clears :data:`MAIN_PEAK_MIN_HEIGHT`.  The optional candidate
    filters and intensity window mirror the reference's ``find_main_peak``
    keywords (``descriptors.py:76``); both bounds of the width and
    prominence pairs are honored, width in energy units (reference
    ``_peaks`` converts eV -> samples the same way)."""
    idx = _candidates(view, lo=lo, hi=hi, min_height=MAIN_PEAK_MIN_HEIGHT,
                      min_prominence=min_prominence,
                      max_prominence=max_prominence,
                      min_width=min_width, max_width=max_width)
    if len(idx):
        heights = view.spec[idx]
        ranked = np.sort(heights)
        leftmost_wins = len(idx) == 1 or (ranked[-1] - ranked[-2] < MAIN_PEAK_TALLER_BY)
        pos = float(view.grid[idx[0] if leftmost_wins else idx[np.argmax(heights)]])
    else:
        valleys = _candidates(view, signal="-d2", lo=lo, hi=hi)
        pos = float(view.grid[valleys[np.argmin(view.spec[valleys])]])
    refined = refine_extremum(view, pos, REFINE_WINDOW["main_peak"], "max")
    return {
        "position": pos,
        "intensity": view.window_mean(
            pos, INTENSITY_WINDOW if intensity_window is None
            else intensity_window),
        "curvature": refined["curvature"],
    }


def pit_descriptor(view: SpectrumView, edge_position: float,
                   curvature_window: Optional[float] = None):
    """Deepest local minimum right of edge + :data:`PIT_SEARCH_OFFSET`,
    quadratically refined; optional band-averaged curvature readout."""
    lo = edge_position + PIT_SEARCH_OFFSET
    minima = _candidates(view, signal="-spec", lo=lo)
    if len(minima):
        guess = float(view.grid[minima[np.argmin(view.spec[minima])]])
    else:
        region = view.grid > lo
        guess = float(view.grid[region][np.argmin(view.spec[region])])
    out = refine_extremum(view, guess, REFINE_WINDOW["pit"], "min")
    if curvature_window is not None:
        band = (view.grid > out["position"] - curvature_window / 2) & (
            view.grid < out["position"] + curvature_window / 2
        )
        out["curvature"] = _mean_abs_d2(view, band)
    return out


def last_peak_descriptor(view: SpectrumView, pit_position: float):
    """First prominent peak right of the pit (grid end as the fallback)."""
    idx = _candidates(view, lo=pit_position, min_prominence=LAST_PEAK_PROMINENCE)
    guess = float(view.grid[idx[0]]) if len(idx) else float(view.grid[-1])
    return refine_extremum(view, guess, REFINE_WINDOW["last_peak"], "max")


def sec_peak_descriptor(view: SpectrumView, main_position: float,
                        pit_position: float):
    """Shoulder between main peak and pit: the most intense curvature valley
    (peak of -d2) in the band; midpoint fallback with zero curvature."""
    lo = main_position + SEC_PEAK_BAND[0]
    hi = pit_position - SEC_PEAK_BAND[1]
    idx = _candidates(view, signal="-d2", lo=lo, hi=hi,
                      min_prominence=SEC_PEAK_PROMINENCE)
    if len(idx):
        i = idx[np.argmax(view.spec[idx])]
        return {"position": float(view.grid[i]),
                "intensity": float(view.spec[i]),
                "curvature": float(-view.d2[i])}
    mid = (main_position + pit_position) / 2
    return {"position": mid, "intensity": float(view.spec[view.nearest(mid)]),
            "curvature": 0.0}


def pre_peak_descriptor(view: SpectrumView, edge_position: float):
    """Pre-edge feature: tallest peak below the edge; curvature-valley
    fallback; (None, 0) when the pre-edge region is featureless."""
    lo = float(view.grid[0]) + PRE_PEAK_LEFT_OFFSET
    idx = _candidates(view, lo=lo, hi=edge_position - PRE_PEAK_RIGHT_MARGIN)
    if len(idx):
        i = idx[np.argmax(view.spec[idx])]
        return {"position": float(view.grid[i]), "intensity": float(view.spec[i]),
                "curvature": None}
    idx = _candidates(view, signal="-d2", lo=lo,
                      hi=edge_position - PRE_PEAK_FALLBACK_RIGHT_MARGIN)
    if len(idx):
        i = idx[np.argmax(-view.d2[idx])]
        return {"position": float(view.grid[i]), "intensity": float(view.spec[i]),
                "curvature": None}
    return {"position": None, "intensity": 0, "curvature": None}


def post_peak_fluctuation(view: SpectrumView, main_position: float) -> float:
    return _mean_abs_d2(view, view.grid > main_position)


def intensity_at_energy(view: SpectrumView, energy: float,
                        edge_position: Optional[float] = None):
    """Windowed intensity readout; energies below
    :data:`RELATIVE_ENERGY_MAX` are offsets from the edge.  Returns
    (label_energy, absolute_energy, intensity)."""
    label = round(energy, 1)
    absolute = label + edge_position if label < RELATIVE_ENERGY_MAX else label
    return label, absolute, view.window_mean(absolute)


# --------------------------------------------------------------------------- #
# orchestration
# --------------------------------------------------------------------------- #

def extract_descriptors(view: SpectrumView, features="all",
                        energy: Optional[float] = None,
                        return_edge_curve: bool = False):
    """Run the requested extractors in dependency order and return the nested
    descriptor dict {feature_group: {name: value}} (plus the fitted arctan
    edge curve when ``return_edge_curve`` — avoids re-running the curve_fit
    for callers that also plot it)."""
    want = lambda f: features == "all" or f in features
    out: Dict[str, Dict] = {"other": {}}

    arctan = None
    if want("edge") or energy is not None:
        out["edge"], arctan = edge_descriptor(view)
    edge_pos = out.get("edge", {}).get("position")
    if want("main_peak"):
        out["main_peak"] = main_peak_descriptor(view)
    if want("pit"):
        out["pit"] = pit_descriptor(view, edge_pos if edge_pos is not None
                                    else float(view.grid[0]))
    if want("sec_peak") and "main_peak" in out and "pit" in out:
        out["sec_peak"] = sec_peak_descriptor(
            view, out["main_peak"]["position"], out["pit"]["position"])
    if want("last") and "pit" in out:
        out["last_peak"] = last_peak_descriptor(view, out["pit"]["position"])
        out["other"]["pit_last_spread"] = (
            out["last_peak"]["intensity"] - out["pit"]["intensity"])
    if want("peak_separation") and "main_peak" in out:
        if "last_peak" in out:
            out["other"]["main_last_separation"] = (
                out["last_peak"]["position"] - out["main_peak"]["position"])
        if "pit" in out:
            out["other"]["main_pit_separation"] = (
                out["pit"]["position"] - out["main_peak"]["position"])
    if want("pre_peak") and edge_pos is not None:
        out["pre_peak"] = pre_peak_descriptor(view, edge_pos)
    if want("fluctuation") and "main_peak" in out:
        out["other"]["fluctuation"] = post_peak_fluctuation(
            view, out["main_peak"]["position"])
    if energy is not None:
        label, _, value = intensity_at_energy(view, energy, edge_pos)
        out["other"][f"intensity_{label:.1f}"] = value
    return (out, arctan) if return_edge_curve else out


def flatten_descriptors(nested: Dict[str, Dict]) -> Dict[str, float]:
    """Flatten to the reference's CSV naming contract: ``<group>_<name>``
    for features, bare names for the derived "other" scalars; the edge
    intensity and unset values are omitted (reference ``as_dict`` rule)."""
    flat: Dict[str, float] = {}
    for group, values in nested.items():
        for name, value in values.items():
            if value is None:
                continue
            if group == "other":
                flat[name] = value
            elif not (group == "edge" and name == "intensity"):
                flat[f"{group}_{name}"] = value
    return flat


def extract_descriptors_batch(grid, specs, features="all", energy=None):
    """Descriptors for a whole (N, L) spectrum matrix -> list of flat dicts.

    The batch workflow the reference supports only one object at a time;
    rows whose extraction fails yield an empty dict instead of aborting the
    batch.
    """
    specs = np.atleast_2d(np.asarray(specs, float))
    out = []
    for row in specs:
        try:
            nested = extract_descriptors(SpectrumView.build(grid, row),
                                         features=features, energy=energy)
            out.append(flatten_descriptors(nested))
        except (ValueError, IndexError):
            out.append({})
    return out


# --------------------------------------------------------------------------- #
# reference-style API wrapper
# --------------------------------------------------------------------------- #


class SpecDescriptors:
    """Compatibility wrapper exposing the reference's incremental
    ``find_*()`` API over the functional core above.  Results live in the
    ``edge`` / ``main_peak`` / ``pit`` / ``last_peak`` / ``sec_peak`` /
    ``pre_peak`` / ``other`` dict attributes, as reference-style notebooks
    expect."""

    GROUPS = ("edge", "main_peak", "pit", "last_peak", "sec_peak", "pre_peak")

    def __init__(self, grid, spec):
        self.view = SpectrumView.build(grid, spec)
        self.spline: Optional[UnivariateSpline] = None
        self.arctan: Optional[np.ndarray] = None
        self.edge: Dict = {}
        self.main_peak: Dict = {}
        self.pit: Dict = {}
        self.last_peak: Dict = {}
        self.sec_peak: Dict = {}
        self.pre_peak: Dict = {}
        self.other: Dict = {}

    @classmethod
    def from_spline(cls, grid, spec, *, fine_grid, k=5, s=0.01) -> "SpecDescriptors":
        view, spl = SpectrumView.from_spline(grid, spec, fine_grid=fine_grid,
                                             k=k, s=s)
        obj = cls(fine_grid, view.spec)
        obj.view = view
        obj.spline = spl
        return obj

    # convenience passthroughs
    @property
    def grid(self):
        return self.view.grid

    @property
    def spec(self):
        return self.view.spec

    # incremental extraction API ---------------------------------------- #

    def find_edge(self):
        self.edge, self.arctan = edge_descriptor(self.view)

    def find_main_peak(self, window=1, left=None, right=None,
                       width=(0, None), prominence=(0, None)):
        """Reference signature (``descriptors.py:76``): ``window`` is the
        intensity-averaging width; ``width`` (energy units, converted to
        samples like the reference's ``_peaks``) and ``prominence`` are
        (min, max) candidate filters — both bounds forwarded."""
        if not isinstance(width, (tuple, list)):
            width = (width, None)
        if not isinstance(prominence, (tuple, list)):
            prominence = (prominence, None)
        self.main_peak = main_peak_descriptor(
            self.view, lo=left, hi=right,
            min_prominence=prominence[0] or 0.0,
            max_prominence=prominence[1],
            min_width=width[0] or 0.0, max_width=width[1],
            intensity_window=window)

    def find_main_pit(self, curvature_window=None):
        self.pit = pit_descriptor(self.view, self.edge["position"],
                                  curvature_window=curvature_window)

    def find_last_peak(self):
        self.last_peak = last_peak_descriptor(self.view, self.pit["position"])

    def find_sec_peak(self):
        self.sec_peak = sec_peak_descriptor(self.view,
                                            self.main_peak["position"],
                                            self.pit["position"])

    def find_pre_peak(self):
        self.pre_peak = pre_peak_descriptor(self.view, self.edge["position"])

    def find_fluctuation(self):
        self.other["fluctuation"] = post_peak_fluctuation(
            self.view, self.main_peak["position"])

    def find_pit_last_spread(self):
        self.other["pit_last_spread"] = (
            self.last_peak["intensity"] - self.pit["intensity"])

    def find_peak_separation(self):
        self.other["main_last_separation"] = (
            self.last_peak["position"] - self.main_peak["position"])
        self.other["main_pit_separation"] = (
            self.pit["position"] - self.main_peak["position"])

    def find_intensity_at_energy(self, energy, window=INTENSITY_WINDOW):
        label = round(energy, 1)
        absolute = (label + self.edge.get("position", 0.0)
                    if label < RELATIVE_ENERGY_MAX else label)
        if label < RELATIVE_ENERGY_MAX:
            self._energy_position = absolute
        self.other[f"intensity_{label:.1f}"] = self.view.window_mean(
            absolute, window)

    def find_descriptors(self, features="all", energy=None):
        nested, arctan = extract_descriptors(
            self.view, features=features, energy=energy, return_edge_curve=True)
        for group in self.GROUPS:
            if group in nested:
                setattr(self, group, nested[group])
        self.other.update(nested["other"])
        if arctan is not None:
            # keep the fitted curve available for plotting (no second fit)
            self.arctan = arctan

    def as_dict(self) -> Dict[str, float]:
        nested = {g: getattr(self, g) for g in self.GROUPS if getattr(self, g)}
        nested["other"] = self.other
        return flatten_descriptors(nested)

    def plot(self, ax, vlines=(), hlines=()):
        ax.plot(self.view.grid, self.view.spec)
        if self.arctan is not None:
            ax.plot(self.view.grid, self.arctan, lw=0.5, color="g")
        for group in self.GROUPS:
            d = getattr(self, group)
            if d.get("position") is not None and d.get("intensity") is not None:
                ax.plot(d["position"], d["intensity"], color="r", marker="o")
        for line in vlines:
            ax.axvline(line, color="k", alpha=0.5)
        for line in hlines:
            ax.axhline(line, color="k", alpha=0.5)
