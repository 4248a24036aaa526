"""PESQ absolute-scale anchoring: fixture codecs + published corpus targets.

Twin of the JAX package's ``tools/pesq_calibrate.py`` on the port's numpy
copies (``eval/pesq_native.py``, ``eval/fixture_codecs.py``) and the
deterministic suite of ``tools/pesq_conformance.py``'s twin.

pip ``pesq`` (the ITU C wrapper the reference uses,
reference ``tools/base_eval/evaluator.py:36-59``) is unavailable and
un-downloadable in this environment, so the native implementation's absolute
scale is anchored against *in-repo implementable standards* instead:

  1. **Fixture codecs** (``eval/fixture_codecs.py``): G.711 u/A-law, the
     G.726 ADPCM ladder (16/24/32/40 kbit/s) and P.810 MNRU, run over the
     real demo-page speech of the reference checkout named by
     ``--reference_root`` (a synthetic carrier without it) and scored with
     native PESQ-NB.  Their ITU-PESQ
     scores are published in the codec literature; the recorded deltas are
     the absolute-scale anchor for waveform-type distortion.
  2. **Published corpus averages** (reference README:35-40 and the demo
     page): the WB operating range for neural-codec reconstructions.  These
     fit the waveform-coherence regime correction
     (``pesq_native._COH_GAIN``) that moves vocoded pairs from the literal
     stage-4 model's ~4.4 WB read into the published ITU range.
  3. **Invariance check**: the coherence excess must be ZERO on the entire
     waveform-preserving degradation matrix (AWGN/lowpass/quant/clip/level/
     delay + every fixture codec) so the previously ITU-tracked AWGN
     calibration (_RAW_CAL) remains valid untouched.

It also refits the NB raw->MOS curve (weighted monotone PAVA over the AWGN
anchors, which must stay within their recorded ITU tolerance, plus the
fixture-codec literature mid-ranges) and prints the fitted table.

Run:  python -m simwhisper_codec_tpu_torch.tools.pesq_calibrate [--out PATH]
          [--reference_root R] [--fit-nb]   # print a refit NB _RAW_CAL

The report goes to ``docs/torch/PESQ_CALIBRATION.json`` by default; the JAX
package's record (``docs/PESQ_CALIBRATION.json``) is never overwritten.

The JSON artifact records every anchor condition, the native score, the
published range, the delta, and the invariance checks — the recorded
deviation bound VERDICT r4 task 1 asks for.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from simwhisper_codec_tpu_torch.eval import pesq_native as P
from simwhisper_codec_tpu_torch.eval.fixture_codecs import g711_alaw, g711_ulaw, g726, mnru
from simwhisper_codec_tpu_torch.tools import pesq_conformance as pc

# Literature ITU-PESQ ranges for the fixture codecs (NB MOS-LQO, clean
# speech).  Sources: ITU-T codec characterization summaries and the PESQ
# validation literature; ranges are deliberately wide because published
# numbers vary with corpus, level and filtering chain (+-0.2 typical).
NB_ANCHORS = {
    "g711_ulaw": {"fn": g711_ulaw, "range": (4.0, 4.5)},
    "g711_alaw": {"fn": g711_alaw, "range": (4.0, 4.5)},
    "g726_40k": {"fn": lambda x: g726(x, 40000), "range": (3.9, 4.4)},
    "g726_32k": {"fn": lambda x: g726(x, 32000), "range": (3.6, 4.1)},
    "g726_24k": {"fn": lambda x: g726(x, 24000), "range": (3.1, 3.7)},
    "g726_16k": {"fn": lambda x: g726(x, 16000), "range": (2.2, 3.1)},
    # MNRU: monotonicity anchors only (published MOS-vs-Q curves are
    # subjective-test-specific); recorded without a range.
    "mnru_q30": {"fn": lambda x: mnru(x, 30.0), "range": None},
    "mnru_q20": {"fn": lambda x: mnru(x, 20.0), "range": None},
    "mnru_q10": {"fn": lambda x: mnru(x, 10.0), "range": None},
}

# Published WB corpus averages for the reconstruction regime
# (reference README.md:35-40, LibriSpeech test-clean).  The demo pairs
# are the paper's showcase samples, so the expected demo read is the corpus
# average plus a cherry-pick margin; we record both.
WB_PUBLISHED = {"simwhisper": 2.72}
DEMO_MARGIN = 0.5  # assumed showcase-vs-corpus margin (recorded assumption)


def _mean_nb_score(fn, carriers) -> float:
    vals = []
    for x in carriers.values():
        x8 = P._poly_resample(x, 16000, 8000)
        vals.append(P.pesq(8000, x8, fn(x8), "nb"))
    return float(np.mean(vals))


def _excess(ds, da, coh) -> float:
    drop = 0.1 * ds + 0.0309 * da
    allowance = P._COH_A * drop + P._COH_B * drop ** 2 + P._COH_FLOOR
    return max(0.0, coh - allowance)


def _invariance_check(carriers) -> dict:
    """Max coherence excess over every waveform-preserving condition."""
    worst = {"condition": None, "excess": 0.0}
    for cname, x in carriers.items():
        for dname, y in pc.degradations(x, 16000).items():
            raw, ds, da, coh = P.pesq_raw(x, y, 16000, _components=True)
            excess = _excess(ds, da, coh)
            if excess > worst["excess"]:
                worst = {"condition": f"{cname}/{dname}", "excess": round(excess, 5)}
    for aname, spec in NB_ANCHORS.items():
        for cname, x in carriers.items():
            x8 = P._poly_resample(x, 16000, 8000)
            raw, ds, da, coh = P.pesq_raw(x8, spec["fn"](x8), 8000, wb=False,
                                          _components=True)
            excess = _excess(ds, da, coh)
            if excess > worst["excess"]:
                worst = {"condition": f"{cname}/{aname}", "excess": round(excess, 5)}
    return worst


def _demo_pairs(sr=16000, assets=None):
    from simwhisper_codec_tpu_torch.utils.audio_io import load_audio

    pairs = {}
    if not (assets and assets.is_dir()):
        return pairs
    for fam in pc.CODEC_FAMILIES:
        for i in (1, 2, 3, 4):
            gt = assets / f"gt_sample{i}.wav"
            rec = assets / f"{fam}_sample{i}.wav"
            if gt.exists() and rec.exists():
                r = np.asarray(load_audio(gt, sr), np.float64)
                d = np.asarray(load_audio(rec, sr), np.float64)
                m = min(len(r), len(d))
                pairs.setdefault(fam, []).append((r[:m], d[:m]))
    return pairs


def _mos_inv_nb(mos: float) -> float:
    """Invert the P.862.1 logistic (target MOS -> cal-domain raw)."""
    y = np.clip((mos - 0.999) / 4.0, 1e-6, 1 - 1e-6)
    return float((4.6607 - np.log(1.0 / y - 1.0)) / 1.4945)


def _pava(xs, ys, ws):
    """Weighted isotonic (non-decreasing) regression, pool-adjacent-violators."""
    blocks = [[y, w, [i]] for i, (y, w) in enumerate(zip(ys, ws))]
    merged = True
    while merged:
        merged = False
        i = 0
        while i < len(blocks) - 1:
            if blocks[i][0] > blocks[i + 1][0] + 1e-12:
                y0, w0, i0 = blocks[i]
                y1, w1, i1 = blocks[i + 1]
                blocks[i] = [(y0 * w0 + y1 * w1) / (w0 + w1), w0 + w1, i0 + i1]
                del blocks[i + 1]
                merged = True
            else:
                i += 1
    out = np.empty(len(ys))
    for y, w, idx in blocks:
        out[idx] = y
    return out


# The round-3 NB curve (fitted on the ITU-tracked speech+AWGN experiment);
# AWGN targets for the refit are pinned to THIS table so the fit is
# reproducible after the refit result is baked into pesq_native._RAW_CAL.
_NB_CURVE_R3 = ([1.0, 2.2373, 2.3487, 2.5214, 2.8679, 3.2199, 3.7532, 4.5],
                [0.1, 1.3094, 1.8180, 2.1920, 2.7775, 3.2535, 3.7681, 4.5])


def fit_nb_curve(carriers) -> dict:
    """Refit _RAW_CAL[False]: AWGN anchors (keep the round-3 ITU-tracked
    outputs, high weight) + fixture literature mid-ranges (lower weight),
    monotone PAVA."""
    pts = []  # (raw, target_cal, weight, label)
    # AWGN ladder on the real carriers: targets = the round-3 ITU-tracked
    # curve's outputs (recorded tolerance 0.35), weight 1.0
    for snr in (40, 35, 30, 25, 20, 15, 10, 5):
        for cname, x in carriers.items():
            x8 = P._poly_resample(x, 16000, 8000)
            rng = np.random.default_rng(0xA)
            n = rng.standard_normal(len(x8)) * np.std(x8) * 10 ** (-snr / 20)
            raw = P.pesq_raw(x8, x8 + n, 8000, wb=False)
            target = float(np.interp(raw, *_NB_CURVE_R3))
            pts.append((raw, target, 1.0, f"awgn_{snr}/{cname}"))
    # fixture codecs: literature mid-range targets, weight 0.5
    for aname, spec in NB_ANCHORS.items():
        if spec["range"] is None:
            continue
        lo, hi = spec["range"]
        target_cal = _mos_inv_nb(0.5 * (lo + hi))
        for cname, x in carriers.items():
            x8 = P._poly_resample(x, 16000, 8000)
            raw = P.pesq_raw(x8, spec["fn"](x8), 8000, wb=False)
            pts.append((raw, target_cal, 0.5, f"{aname}/{cname}"))
    # pin the endpoints hard
    pts.append((4.5, 4.5, 100.0, "ceiling"))
    pts.append((1.0, 0.1, 100.0, "floor"))
    pts.sort(key=lambda t: t[0])
    raws = np.array([t[0] for t in pts])
    fitted = _pava(raws, np.array([t[1] for t in pts]),
                   np.array([t[2] for t in pts]))
    # condense to a compact knot table (dedupe nearly-equal raws)
    knots_x, knots_y = [], []
    for r, f in zip(raws, fitted):
        if not knots_x or r - knots_x[-1] > 0.05:
            knots_x.append(round(float(r), 4))
            knots_y.append(round(float(f), 4))
        else:
            knots_y[-1] = round(0.5 * (knots_y[-1] + float(f)), 4)
    return {"xs": knots_x, "ys": knots_y}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(pc.REPO_ROOT / "docs" / "torch" / "PESQ_CALIBRATION.json"))
    ap.add_argument("--fit-nb", action="store_true",
                    help="refit and print the NB _RAW_CAL knot table")
    ap.add_argument("--reference_root", default=None, help=pc.REFERENCE_HELP)
    args = ap.parse_args(argv)
    out = pc.out_path(ap, args.out)
    assets = pc.ref_assets(args.reference_root)

    carriers = pc.load_carriers(16000, assets)
    report = {
        "carriers": sorted(carriers),
        "coherence_term": {
            "allowance_linear": P._COH_A, "allowance_quadratic": P._COH_B,
            "floor": P._COH_FLOOR, "tau": P._COH_TAU,
            "gain_wb": P._COH_GAIN[True], "gain_nb": P._COH_GAIN[False],
        },
    }

    # 1. invariance: waveform-preserving conditions must have zero excess
    report["invariance_worst_excess"] = _invariance_check(carriers)

    # 1b. AWGN drift vs the round-3 ITU-tracked NB curve: the refit must
    # keep every ladder point within the recorded 0.35 ITU tolerance
    drift = 0.0
    for snr in (40, 35, 30, 25, 20, 15, 10, 5):
        for cname, x in carriers.items():
            x8 = P._poly_resample(x, 16000, 8000)
            rng = np.random.default_rng(0xA)
            n = rng.standard_normal(len(x8)) * np.std(x8) * 10 ** (-snr / 20)
            raw = P.pesq_raw(x8, x8 + n, 8000, wb=False)
            now = P.mos_lqo_nb(P._calibrate_raw(raw, False))
            r3 = P.mos_lqo_nb(float(np.interp(raw, *_NB_CURVE_R3)))
            drift = max(drift, abs(now - r3))
    report["nb_awgn_drift_vs_r3"] = {"max_abs_mos": round(drift, 3),
                                     "itu_tolerance": 0.35}

    # 2. NB fixture-codec anchors vs literature
    nb = {}
    for aname, spec in NB_ANCHORS.items():
        score = round(_mean_nb_score(spec["fn"], carriers), 3)
        entry = {"native_nb": score, "published_range": spec["range"]}
        if spec["range"]:
            lo, hi = spec["range"]
            entry["delta_outside_range"] = round(
                max(0.0, score - hi) + min(0.0, score - lo), 3)
        nb[aname] = entry
    report["nb_anchors"] = nb
    in_range = [v for v in nb.values() if v["published_range"]]
    report["nb_anchor_bound"] = {
        "max_abs_delta_outside_range": round(
            max(abs(v["delta_outside_range"]) for v in in_range), 3),
        "n_inside": sum(1 for v in in_range if v["delta_outside_range"] == 0),
        "n_total": len(in_range),
    }

    # 3. WB vocoded regime: demo pairs vs published corpus averages
    wb = {}
    for fam, pairs in _demo_pairs(assets=assets).items():
        scores = [P.pesq(16000, r, d, "wb") for r, d in pairs]
        nb_scores = [P.pesq(16000, r, d, "nb") for r, d in pairs]
        wb[fam] = {"native_wb_mean": round(float(np.mean(scores)), 3),
                   "native_nb_mean": round(float(np.mean(nb_scores)), 3),
                   "native_wb_per_pair": [round(s, 3) for s in scores]}
        if fam in WB_PUBLISHED:
            wb[fam]["published_corpus_wb"] = WB_PUBLISHED[fam]
            wb[fam]["delta_vs_corpus_plus_margin"] = round(
                wb[fam]["native_wb_mean"] - (WB_PUBLISHED[fam] + DEMO_MARGIN), 3)
    report["wb_codec_pairs"] = wb
    report["wb_demo_margin_assumption"] = DEMO_MARGIN
    if "simwhisper" in wb:
        ranking = sorted(wb, key=lambda f: -wb[f]["native_wb_mean"])
        report["wb_ranking"] = ranking
        # 4 showcase pairs cannot resolve <0.15 MOS gaps (the published
        # corpus table's own top gap is 0.04); report the tie group
        top = wb[ranking[0]]["native_wb_mean"]
        report["wb_top_tie_group"] = [f for f in ranking
                                      if top - wb[f]["native_wb_mean"] < 0.15]
        report["wb_simwhisper_in_top_group"] = (
            "simwhisper" in report["wb_top_tie_group"])

    if args.fit_nb:
        report["nb_curve_refit"] = fit_nb_curve(carriers)

    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("wb_codec_pairs",)}, indent=1))
    print(json.dumps(report.get("wb_codec_pairs", {}), indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
