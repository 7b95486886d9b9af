"""Codec evaluation CLI (counterpart of
``rstnet_tpu/evalsuite/compute_metrics.py``): for a reference dir and a
degraded (reconstructed) dir of matching wavs, every available metric
(SI-SNR, mel-SSIM, STOI, MCD, MS-STFT; PESQ and ViSQOL where their backends
exist), per file and averaged, printed and optionally written as JSON.

    python -m rstnet_tpu_torch.evalsuite.compute_metrics --ref_dir A --deg_dir B [--output F]

It runs on the CPU (numpy, scipy and the port's STFT).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from rstnet_tpu_torch.evalsuite import metrics as M
from rstnet_tpu_torch.utils.audio import read_wav, resample_linear


def evaluate_pair(ref_path: str, deg_path: str, sr: int = 24000) -> dict:
    ref, sr_r = read_wav(ref_path)
    deg, sr_d = read_wav(deg_path)
    ref = resample_linear(ref, sr_r, sr)[0]
    deg = resample_linear(deg, sr_d, sr)[0]
    out = {"si_snr": M.si_snr(ref, deg), "mel_ssim": M.mel_ssim(ref, deg, sr),
           "stoi": M.stoi(ref, deg, sr), "mcd": M.mcd(ref, deg, sr),
           "ms_stft": M.ms_stft_distance(ref, deg)}
    ref16 = resample_linear(ref[None], sr, 16000)[0]
    deg16 = resample_linear(deg[None], sr, 16000)[0]
    pesq = M.pesq_score(ref16, deg16)
    if pesq is not None:
        out["pesq_wb"] = pesq
    visqol = M.visqol_score(ref_path, deg_path)
    if visqol is not None:
        out["visqol"] = visqol
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_dir", required=True)
    parser.add_argument("--deg_dir", required=True)
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--output", default="")
    args = parser.parse_args(argv)

    results = {}
    for ref_path in sorted(Path(args.ref_dir).glob("*.wav")):
        deg_path = Path(args.deg_dir) / ref_path.name
        if deg_path.exists():
            results[ref_path.name] = evaluate_pair(str(ref_path), str(deg_path),
                                                   args.sample_rate)
    if not results:
        raise SystemExit("no matching wav pairs found")
    all_keys = sorted({k for r in results.values() for k in r})
    means = {k: float(np.nanmean([r[k] for r in results.values()
                                  if k in r and r[k] is not None]))
             for k in all_keys}
    report = {"mean": means, "files": results, "n": len(results)}
    print(json.dumps(report["mean"], indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
