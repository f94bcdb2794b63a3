"""Configuration system.

The reference's knobs are compile-time ``#define``s and top-of-file constants
(``main.cpp:1-2,23-40``; ``optimize_H.cpp:12-14``; ``qpadmm_params.cpp:12-14``).
Here every knob is a dataclass field with CLI exposure (SURVEY.md §5 "config
/ flag system"). Defaults reproduce the reference's OPTIMAL benchmark config.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

DEFAULT_SNRS = (-5.0, -4.5, -4.0, -3.5, -3.0, -2.5, -2.0, -1.5, -1.0, -0.5, 0.0)

# The one place that picks a path per platform, keyed on
# ``jax.devices()[0].platform``. ``bp_layout`` is BPDecoder's layout for
# layout="auto"; ``gauss`` is the GF(2) elimination backend for
# backend="auto" (the Triton kernel needs a CUDA card).
PLATFORM_POLICY = {
    "gpu": {"bp_layout": "mxu", "gauss": "triton"},
    "cpu": {"bp_layout": "mxu", "gauss": "xla"},
}


def platform_choice(key: str, platform: str | None = None) -> str:
    """The policy's choice of ``key`` for ``platform`` (default: the
    platform of the first JAX device). An unknown platform raises: it
    gets no other platform's choices."""
    if platform is None:
        import jax
        platform = jax.devices()[0].platform
    if platform not in PLATFORM_POLICY:
        raise ValueError(f"no kernel policy for platform {platform!r}; "
                         f"known: {sorted(PLATFORM_POLICY)}")
    return PLATFORM_POLICY[platform][key]


@dataclass
class DecoderConfig:
    """Union of per-decoder hyperparameters (reference: main.cpp:28-40)."""

    bp_max_iter: int = 100
    bp_variant: str = "sumprod"          # or "minsum"
    bp_layout: str = "auto"              # auto | edge | dense | mxu
    admm_alpha: float = 1.2              # OPTIMAL config (main.cpp:30)
    admm_mu: float = 0.55
    admm_max_iter: int = 10000
    admm_eps_stop: float = 1e-5
    agc_max_rows: int = 1000             # main.cpp:38
    lp_max_rounds: int = 64              # ALP cut rounds cap (while-loop guard)
    # PDHG chunk length between violation/stall checks. Smaller chunks stop
    # warm-started re-solves sooner (the cut loops re-solve after adding a
    # handful of rows); 64 was found FER-neutral at -3 dB against 600.
    lp_iters: int = 64
    # FullLP's *total* PDHG iteration budget. Distinct from lp_iters, which
    # became the chunk length of the adaptive solvers: FullLP solves one
    # static LP over the whole cascaded polytope and needs the full budget
    # up front (lp.py).
    full_lp_iters: int = 2000
    # Integrality-certificate tolerance. The reference tests coordinates
    # against EPS=1e-8 after an *exact* dual-simplex solve (full_lp.h:44-59);
    # a first-order PDHG solve leaves up to ~1.5e-2 coordinate noise on true
    # vertex optima, while genuinely fractional LP optima (pseudocodewords)
    # have coordinates >= 1/3 away from integrality — measured failure
    # deviations cluster at <=0.015 vs >=0.44. 3e-2 sits in that gap; a
    # tighter value (1e-3) mis-rejects true integral optima and inflates
    # FER ~3x at high SNR.
    lp_int_tol: float = 3e-2


@dataclass
class SweepConfig:
    matrix: str = "data/optimalH.txt"
    generator: str | None = None         # None -> GF(2) nullspace of matrix
    decoders: tuple[str, ...] = ("bp", "qp-admm", "alp", "agc-alp")
    snrs: tuple[float, ...] = DEFAULT_SNRS
    trials: int = 10000                  # TESTS_NUM (main.cpp:25)
    batch_size: int = 0      # 0 = per-decoder measured optimum (decoders.DEFAULT_BATCH)
    seed: int = 239_239_239              # main.cpp:63
    report: str = "report.csv"
    extended_report: str | None = "report_extended.csv"
    resume: bool = False                 # skip (Method, SNR) rows already in
    # the report and append the rest — crash recovery at row granularity
    # (the reference's streamed report.csv keeps completed rows the same
    # way, main.cpp:79-86)
    shard: bool = True                   # shard trials over the device mesh
    decoder_cfg: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass
class GridSearchConfig:
    """qpadmm_params.cpp:12-14,51-58 equivalents."""

    matrix: str = "data/optimalH.txt"
    trials: int = 1000
    snr: float = -3.0
    alpha_min: float = 0.0
    alpha_max: float = 3.0
    alpha_count: int = 61
    mu_min: float = 0.0
    mu_max: float = 3.0
    mu_count: int = 61
    admm_max_iter: int = 1000
    admm_eps_stop: float = 1e-5
    seed: int = 239
    batch_cells: int = 16               # (alpha, mu) cells vmapped per launch
    grid_out: str = ""                  # optional CSV: one FER row per cell


@dataclass
class OptimizeConfig:
    """optimize_H.cpp:12-14,124-136 equivalents, population-parallel."""

    block_size: int = 20
    block_rows: int = 8
    block_cols: int = 14
    trials: int = 1000
    final_trials: int = 10000
    snr: float = -3.0
    admm_alpha: float = 1.95             # non-OPTIMAL params (optimize_H.cpp:14)
    admm_mu: float = 0.5
    admm_max_iter: int = 1000
    generations: int = 10000             # proposals (optimize_H.cpp:133)
    population: int = 8                  # parallel descent chains (one
    # proposal per chain per generation; the reference is population=1)
    screen_trials: int = 256             # stage-A shared-noise screen size
    screen_iters: int = 600              # ADMM iteration cap for screens
    # only — accepts that can touch the artifact are always confirmed at
    # the full (admm_max_iter, trials) budget, so this trades screen-
    # ranking fidelity for ~1.7x generation throughput
    screen_margin: float = 0.03          # ~2 paired sigma at 256 trials; in
    # polish mode a proposal within this of the incumbent's screen FER
    # earns a full evaluation
    polish_margin: float = 0.04          # chains whose screen FER is within
    # this of the global best's switch from screen-greedy descent to
    # full-budget confirmed accepts (the reference's accept rule)
    kick_after: int = 60                 # consecutive rejections before a
    # chain widens its proposals to multi-block mutations (basin hopping)
    kick_blocks: int = 3                 # blocks mutated per kicked proposal
    reseed_after: int = 200              # consecutive rejections before a
    # chain restarts (alternating global-best-perturbed / fresh random)
    seed: int = 239
    init_matrix: str | None = None       # warm start path; None -> random
    save_path: str = "data/optimalH_search.txt"
    state_path: str = "data/optimize_state.json"


def add_dataclass_args(parser: argparse.ArgumentParser, cfg) -> None:
    for f in dataclasses.fields(cfg):
        if dataclasses.is_dataclass(f.type) or dataclasses.is_dataclass(
                getattr(cfg, f.name)):
            add_dataclass_args(parser, getattr(cfg, f.name))
            continue
        default = getattr(cfg, f.name)
        name = "--" + f.name.replace("_", "-")
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif isinstance(default, tuple):
            # accept both space-separated values and comma-separated lists
            # (--decoders alp agc-alp  ==  --decoders alp,agc-alp)
            ef = float if (default and isinstance(default[0], float)) else str
            elem = lambda s, ef=ef: tuple(ef(p) for p in s.split(",") if p)
            parser.add_argument(name, nargs="*", type=elem, default=default)
        elif default is None:
            parser.add_argument(name, type=str, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def apply_args(cfg, args: argparse.Namespace):
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            apply_args(val, args)
            continue
        if hasattr(args, f.name):
            new = getattr(args, f.name)
            if isinstance(val, tuple) and new is not None:
                # flatten per-arg comma groups from the tuple elem parser
                new = tuple(x for part in new
                            for x in (part if isinstance(part, tuple)
                                      else (part,)))
            setattr(cfg, f.name, new)
    return cfg
