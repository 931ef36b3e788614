"""PSNR parity harness: this framework's predict vs the TF reference; the
port of ``synthsr_tpu/cli/parity.py``, whose "our half" runs the port's
``Predictor`` (on the GPU unless ``--cpu``).  ``--tf_h5`` takes the shipped
Keras ``.h5`` (needs h5py) or a ``torch.save``d state dict ``.pt``.

BASELINE.md's north-star accuracy metric is PSNR >= 40 dB against the shipped
TF weights (``models/SynthSR_v10_210712.h5``, models/models.txt:1-2, loaded by
``scripts/predict_command_line.py:65-79``).  The weight blobs are git-LFS
-missing in this environment, so the check cannot run here — this harness
makes it a one-command check the moment the blobs are obtainable:

  # 1. produce TF-reference outputs once (on any machine with the reference):
  #      python scripts/predict_command_line.py <input_dir> <tf_out_dir>
  # 2. run this framework + compare:
  python -m synthsr_tpu_torch.cli.parity --tf_h5 SynthSR_v10_210712.h5 \
      --input_dir <input_dir> --reference_dir <tf_out_dir> [--output_dir d]

Prints per-volume and mean PSNR (peak = 128, the fixed output scale of
``predict_command_line.py:134-136``) and exits non-zero below --threshold.

Without --reference_dir it only writes this framework's predictions (the
"our half" of the comparison).  ``compare_dirs`` can also diff any two
prediction directories produced separately.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

OUTPUT_PEAK = 128.0  # predict outputs are clipped to [0, 128] (reference :136)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = OUTPUT_PEAK) -> float:
    """PSNR in dB over the whole volume; inf when identical."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def compare_dirs(pred_dir: str, reference_dir: str, peak: float = OUTPUT_PEAK):
    """Pair files of two prediction dirs by sorted order; returns
    [(name, psnr)]. Volumes are resliced is NOT done — shapes must match."""
    from ..io.volume import load_volume
    from ..utils.misc import list_images_in_folder

    preds = list_images_in_folder(pred_dir)
    refs = list_images_in_folder(reference_dir)
    if len(preds) != len(refs):
        raise ValueError(f"{pred_dir} has {len(preds)} volumes but "
                         f"{reference_dir} has {len(refs)}")
    results = []
    for p, r in zip(preds, refs):
        a = load_volume(p, dtype="float32")
        b = load_volume(r, dtype="float32")
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch {os.path.basename(p)}: "
                             f"{a.shape} vs {b.shape}")
        results.append((os.path.basename(p), psnr(a, b, peak)))
    return results


def build_arg_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tf_h5", required=True,
                   help="path to the shipped TF weights "
                        "(e.g. SynthSR_v10_210712.h5; needs h5py) or a torch.save'd "
                        "state dict (.pt)")
    p.add_argument("--input_dir", required=True,
                   help="directory of input volumes to predict")
    p.add_argument("--reference_dir", default=None,
                   help="directory of TF-reference predictions of the same "
                        "inputs (sorted-order pairing); omit to only write "
                        "this framework's predictions")
    p.add_argument("--output_dir", default=None,
                   help="where to save this framework's predictions "
                        "(default: temp dir)")
    p.add_argument("--threshold", type=float, default=40.0,
                   help="exit non-zero if mean PSNR falls below this (dB)")
    p.add_argument("--ct", action="store_true", help="inputs are CT scans")
    p.add_argument("--disable_flipping", action="store_true",
                   help="disable flip TTA (must match how the reference "
                        "outputs were produced)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the GPU")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    from .predict import Predictor, _prepare_paths

    out_dir = args.output_dir or tempfile.mkdtemp(prefix="synthsr_parity_")
    images, outs = _prepare_paths(args.input_dir, out_dir)
    predictor = Predictor(model_path=args.tf_h5, ct=args.ct,
                          disable_flipping=args.disable_flipping,
                          device="cpu" if args.cpu else None)
    for pin, pout in zip(images, outs):
        print(f"predicting {os.path.basename(pin)}")
        predictor.predict_file(pin, pout)
    print(f"predictions written to {out_dir}")

    if args.reference_dir is None:
        print("no --reference_dir given; skipping PSNR comparison")
        return 0

    results = compare_dirs(out_dir, args.reference_dir)
    for name, val in results:
        print(f"  {name}: {val:.2f} dB")
    mean = float(np.mean([v for _, v in results]))
    ok = mean >= args.threshold
    print(json.dumps({"metric": "psnr_vs_tf_reference", "value": round(mean, 2),
                      "unit": "dB", "threshold": args.threshold, "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
