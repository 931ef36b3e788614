"""Estimate GMM hyperpriors from (image, segmentation) data (the port of
``examples/8_estimate_priors.py``, reference tutorials/8).  Host numpy
work: no device is used."""

from ..synth.estimate_priors import build_intensity_stats
from .common import GEN_CLASSES, GEN_LABELS, LABELS, RESULTS, ensure_images


def main():
    build_intensity_stats(list_image_dir=ensure_images(), list_labels_dir=LABELS,
                          result_dir=f"{RESULTS}/8-priors", estimation_labels=GEN_LABELS,
                          estimation_classes=GEN_CLASSES)


if __name__ == "__main__":
    main()
