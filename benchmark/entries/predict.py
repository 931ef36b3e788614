"""The predict entry: ``synthsr_tpu_torch.cli.predict.Predictor.predict_volume``
on raw scans held in host memory, one at a time in a closed loop, as
``run_batch``'s device stage calls it.

Set-up: the kernels built or loaded, weights drawn on the device and handed
to ``Predictor`` through a ``.pt`` file under the temporary directory, the
scans made from the seed, one warm call per acquisition.  The check: a
sample of the window's outputs of each acquisition, drawn from the seed,
against the plain reference pipeline (``reference/predict.py``) on the same scans and weights.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

import traffic
import work
from reference import predict as ref
from weights import make_unet_weights

FAULTS = ("tta_half", "answer")


class Bench:
    """One predict cell, set up; ``unit(i)`` runs the window's i-th volume."""

    setup_units = 0  # the warm calls are not answers of the window

    def __init__(self, cfg: dict, wl: dict, seed: int, device, fault=None):
        from synthsr_tpu_torch.cli import predict as predict_cli
        from synthsr_tpu_torch.ops import conv_cf

        self.dev, self.cfg, self.wl = torch.device(device), cfg, wl
        if self.dev.type == "cuda":
            conv_cf.build_kernels()
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.sd = make_unet_weights(cfg["network"], cfg["in_channels"], gen, self.dev)
        fd, path = tempfile.mkstemp(suffix=".pt")
        os.close(fd)
        try:
            torch.save(self.sd, path)
            self.predictor = predict_cli.Predictor(
                model_path=path, compute_dtype=cfg["compute_dtype"], ct=cfg["ct"],
                disable_flipping=not cfg["flip_tta"], n_channels=cfg["in_channels"],
                device=self.dev)
        finally:
            os.remove(path)
        self.volumes, self.order = traffic.scans(wl["traffic"], seed, self.dev)
        self._break(fault)
        self.padded = {}
        for v, aff, acq in self.volumes:  # one warm call per acquisition
            if acq not in self.padded:
                x, _, _ = self.predictor.prepare(v, aff)
                self.padded[acq] = tuple(x.shape[2:])
                del x
                self.predictor.predict_volume(v, aff)
        want = wl["traffic"].get("padded")
        if want is not None and set(self.padded.values()) != {tuple(want)}:
            raise RuntimeError(f"padded shapes {self.padded} are not the cell's {want}")
        self.rng = np.random.default_rng(seed)
        self.k = wl["check"]["samples"]
        # a reservoir sample of (volume index, output) for each acquisition
        self.kept = {acq: [] for acq in self.padded}
        self.seen = dict.fromkeys(self.padded, 0)

    def _break(self, fault):
        """A planted fault, for the tests that show a broken run reads not correct."""
        p = self.predictor
        if fault == "tta_half":  # the flipped half of the TTA pair left out
            from synthsr_tpu_torch.models.unet_cf import fast_unet_forward

            p.network = lambda x: fast_unet_forward(p.model, x, p.dtype, p.packed)
        elif fault == "answer":  # a slab of each answer lost where it is produced
            pv = p.predict_volume

            def altered(im, aff):
                out, aff2 = pv(im, aff)
                out = out.copy()
                out[: max(1, out.shape[0] // 8)] = 0.0
                return out, aff2

            p.predict_volume = altered
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")

    def unit(self, i: int):
        idx = self.order[i % len(self.order)]
        vol, aff, acq = self.volumes[idx]
        out, _ = self.predictor.predict_volume(vol, aff)
        kept = self.kept[acq]
        self.seen[acq] += 1
        if len(kept) < self.k:
            kept.append((idx, out))
        else:
            j = int(self.rng.integers(self.seen[acq]))
            if j < self.k:
                kept[j] = (idx, out)

    def sampled(self):
        return [x for acq in sorted(self.kept) for x in self.kept[acq]]

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def unit_work(self, i: int):
        """(conv operations, least seconds) of the window's i-th volume."""
        acq = self.volumes[self.order[i % len(self.order)]][2]
        return work.predict_work(self.cfg["network"], self.cfg["in_channels"], self.padded[acq],
                                 self.cfg["flip_tta"], self.cfg["compute_dtype"])

    def instrument(self, spans):
        p = self.predictor
        spans.wrap(p, "prepare", "prepare")
        spans.wrap(p, "network", "network")
        spans.wrap(p, "predict_volume", "volume")

    def end_to_end(self, times, wall):
        return {"volumes_per_min": len(times) * 60.0 / wall}

    def release(self):
        del self.predictor
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, vol, aff, quant=None):
        return ref.predict(self.sd, self.cfg["network"], vol, aff, self.dev, quant=quant,
                           tta=self.cfg["flip_tta"], ct=self.cfg["ct"])

    def check(self):
        """([(name, value, limit)] over the sampled outputs, the count of
        sampled outputs out of their limits)."""
        lim = self.wl["check"]["limits"]
        rel = gap = 0.0
        failed = 0
        self.detail = []
        for idx, out in self.sampled():
            vol, aff, _ = self.volumes[idx]
            want = self.reference(vol, aff)
            r, g = ref.compare(out, want)
            failed += not (r <= lim["out_rms_gap"] and g <= lim["out_max_gap"])
            rel, gap = max(rel, r), max(gap, g)
            self.detail.append({"volume": idx, "rms_gap": r, "max_gap": g,
                                "ref_mean": float(want.mean()),
                                "ref_clipped": float(np.mean((want <= 0) | (want >= 128)))})
        return [("out_rms_gap", rel, lim["out_rms_gap"]),
                ("out_max_gap", gap, lim["out_max_gap"])], failed

    def control(self, quant):
        """The numbers of the reference computed with ``quant`` in the
        program's place, on the sampled volumes."""
        rel = gap = 0.0
        for idx, _ in self.sampled():
            vol, aff, _ = self.volumes[idx]
            r, g = ref.compare(self.reference(vol, aff, quant), self.reference(vol, aff))
            rel, gap = max(rel, r), max(gap, g)
        return {"out_rms_gap": rel, "out_max_gap": gap}
