"""The train entry: the loop body of ``synthsr_tpu_torch.train.training.training``
without its per-epoch checkpoint.  Label maps come from
``synth/model_inputs.build_model_inputs`` through ``PrefetchIterator(4)``,
are copied to the card, ``make_train_step``'s step generates the pair on the
card and runs the forward, backward and gated Adam, and ``FiniteGuard(lag=2)``
reads each loss two steps late.

Set-up builds these objects as ``training`` does, from the configuration's
settings, with weights drawn on the device from the seed and label maps
written from the seed under the temporary directory, then drives the same
objects through the cell's first steps.  The window goes on from there; its
step that falls due at a fraction of the window drawn from the seed is
checked too, from the parameters and Adam state the window had reached,
kept just before it (the step after the window, if the window ends first).

In each checked step, each example's label map, GMM parameters and random
draws (``Generator.sample``) are recorded with the pair the program made.
The check holds the label map to the maps the benchmark wrote, the pair to
the plain generator (``reference/generator.py``) on that map, those
parameters and draws, and the steps to the plain train step
(``reference/train.py``) on the program's pairs: the first steps from the
seed's weights, the window's step from the kept state.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

import traffic
import work
from reference import generator as ref_gen
from reference import train as ref
from reference.precision import bf16
from weights import make_unet_weights

ADAM_B1 = ref.ADAM_B1

FAULTS = ("state_unchanged", "answer", "pair")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Bench:
    """One train cell, set up and past its checked steps; ``unit(i)`` runs one step."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device, fault=None):
        from synthsr_tpu_torch.io.labels import get_list_labels
        from synthsr_tpu_torch.io.volume import save_volume
        from synthsr_tpu_torch.models.unet import UNet3D
        from synthsr_tpu_torch.ops import conv_cf
        from synthsr_tpu_torch.synth.brain_generator import BrainGenerator
        from synthsr_tpu_torch.synth.labels_to_image import build_generator
        from synthsr_tpu_torch.synth.model_inputs import build_model_inputs
        from synthsr_tpu_torch.synth.sampling import make_gmm_sampler
        from synthsr_tpu_torch.train import training
        from synthsr_tpu_torch.train.metrics import doubled_residual_indices
        from synthsr_tpu_torch.utils.finite_guard import FiniteGuard, adam_init
        from synthsr_tpu_torch.utils.misc import get_padding_margin
        from synthsr_tpu_torch.utils.prefetch import PrefetchIterator

        self.dev, self.cfg, self.wl = torch.device(device), cfg, wl
        self.training = training
        if self.dev.type == "cuda":
            conv_cf.build_kernels()
        t, net = cfg["training"], cfg["network"]
        self.tmp = tempfile.TemporaryDirectory()
        lab_dir = os.path.join(self.tmp.name, "labels")
        os.makedirs(lab_dir)
        maps, means, stds = traffic.label_maps(wl["traffic"], seed)
        for i, lab in enumerate(maps):
            save_volume(lab, np.eye(4), None, os.path.join(lab_dir, f"subject{i}.nii.gz"))
        self.maps = maps
        labels_path = os.path.join(self.tmp.name, "generation_labels.npy")
        np.save(labels_path, traffic.GENERATION_LABELS)
        labels, n_neutral = get_list_labels(label_list=labels_path, labels_dir=lab_dir,
                                            FS_sort=True)
        channels = [bool(c) for c in t["input_channels"]]
        bg = BrainGenerator(
            labels_dir=lab_dir, generation_labels=labels, n_neutral_labels=n_neutral,
            padding_margin=get_padding_margin(t["output_shape"], t["loss_cropping"]),
            batchsize=t["batchsize"], input_channels=channels,
            output_channel=t["output_channel"], output_shape=t["output_shape"],
            output_div_by_n=2 ** net["nb_levels"], prior_means=means, prior_stds=stds,
            prior_distributions="normal", flipping=t["flipping"],
            scaling_bounds=t["scaling_bounds"], rotation_bounds=t["rotation_bounds"],
            shearing_bounds=t["shearing_bounds"], translation_bounds=t["translation_bounds"],
            nonlin_std=t["nonlin_std"], nonlin_shape_factor=t["nonlin_shape_factor"],
            simulate_registration_error=t["simulate_registration_error"],
            randomise_res=t["randomise_res"], data_res=np.array(t["data_res"]),
            thickness=np.array(t["thickness"]), downsample=t["downsample"],
            blur_range=t["blur_range"], build_reliability_maps=t["build_reliability_maps"],
            bias_field_std=t["bias_field_std"], bias_shape_factor=t["bias_shape_factor"],
            seed=seed, device=self.dev)
        self.in_channels = sum(channels) * 2
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.sd0 = make_unet_weights(net, self.in_channels, gen, self.dev)
        model = UNet3D(in_channels=self.in_channels, **net).to(self.dev)
        model.load_state_dict(self.sd0)
        self.param_names = [n for n, _ in model.named_parameters()]
        self.residual = doubled_residual_indices(t["work_with_residual_channel"], True,
                                                 input_channels=channels)
        self.sampler = make_gmm_sampler(
            n_labels=len(labels), prior_means=bg.prior_means, prior_stds=bg.prior_stds,
            prior_distributions="normal", n_channels=bg.n_channels,
            generation_classes=bg.generation_classes)
        self.generator = build_generator(bg.cfg)
        self.ref_settings = ref_gen.settings(
            t, maps[0].shape, net["nb_levels"], traffic.NEUTRAL, traffic.LEFT, traffic.RIGHT)
        self.step = training.make_train_step(
            model, self.generator, self.sampler, t["lr"], 0.0, metrics="l1",
            loss_cropping=t["loss_cropping"], residual_indices=self.residual,
            compute_dtype=_DTYPES[cfg["compute_dtype"]], remat=False)
        self.model = model
        self.opt_state = adam_init(list(model.parameters()))
        self.gen = torch.Generator().manual_seed(seed)
        self.inputs = PrefetchIterator(build_model_inputs(
            path_label_maps=bg.labels_paths, n_labels=len(labels), prior_means=bg.prior_means,
            prior_stds=bg.prior_stds, path_images=None, batchsize=t["batchsize"],
            rng=bg._rng, include_gmm_params=False), buffer_size=4)
        self.guard = FiniteGuard(lag=2)
        self.label_wait_s = 0.0
        self.check_at = float(np.random.default_rng(seed).uniform(0.25, 0.75))
        self.due = self.late = None
        self._break(fault)

        # the checked steps: the window's own call and feed
        n = self.setup_units = wl["check"]["steps"]
        self.records = []
        losses, grad1 = [], None
        for i in range(n):
            before = [m.clone() for m in self.opt_state["mu"]] if i == 0 else None
            losses.append(self._recorded(i))
            if i == 0:
                grad1 = self._grad_norms(before, self.opt_state["mu"])
        change = {k: float((p.detach() - self.sd0[k]).norm())
                  for k, p in zip(self.param_names, model.parameters())}
        self.prog = {"losses": [float(v) for v in losses], "grad1": grad1, "change": change}
        self.sync()

    def _recorded(self, i: int):
        """``unit(i)`` with each example's label map, GMM parameters, draws and
        pair recorded; returns the step's loss."""
        training, generator = self.training, self.generator
        generate, sample = training.generate_batch, generator.sample
        rec = {"labels": [], "gmm": [], "draws": []}

        def sample_recorded(gen):
            draws = sample(gen)
            rec["draws"].append(draws)
            return draws

        def generate_recorded(gen_obj, gmm_sampler, gens, batch, *args, **kwargs):
            def sampler(g):
                params = gmm_sampler(g)
                rec["gmm"].append(tuple(p.detach().clone() for p in params))
                return params

            out = generate(gen_obj, sampler, gens, batch, *args, **kwargs)
            rec["labels"] = batch[0].detach().clone()
            rec["pair"] = (out[0].detach().clone(), out[1].detach().clone())
            return out

        training.generate_batch, generator.sample = generate_recorded, sample_recorded
        try:
            loss = self._step(i)
        finally:
            training.generate_batch = generate
            del generator.sample
        self.records.append(rec)
        return loss

    def _grad_norms(self, mu_before, mu_after) -> dict:
        """Each leaf's gradient norm in a step, as the optimizer got it: from
        its first moments before and after the step."""
        return {k: float(((a - ADAM_B1 * b) / (1.0 - ADAM_B1)).norm())
                for k, a, b in zip(self.param_names, mu_after, mu_before)}

    def open_window(self, seconds: float):
        """The window opens now and lasts ``seconds``: its step due at the
        seeded fraction of it is checked."""
        self.due = time.perf_counter() + self.check_at * seconds

    def _late(self, i: int):
        """Step ``i``, checked: the parameters and Adam state kept before it
        and after it, its inputs and pair recorded."""
        names, params, st = self.param_names, list(self.model.parameters()), self.opt_state
        before = ({k: p.detach().clone() for k, p in zip(names, params)},
                  {k: m.clone() for k, m in zip(names, st["mu"])},
                  {k: v.clone() for k, v in zip(names, st["nu"])}, st["count"].clone())
        loss = self._recorded(i)
        after = ({k: p.detach().clone() for k, p in zip(names, params)},
                 {k: m.clone() for k, m in zip(names, self.opt_state["mu"])})
        self.late = (before, after, loss)
        return loss

    def after_window(self, i: int) -> int:
        """The checked step after the window, if the window ended before its
        step fell due: returns the steps run."""
        if self.late is not None:
            return 0
        self._late(i)
        return 1

    def late_numbers(self) -> dict:
        """The checked window step's loss, gradient norms as the optimizer got
        them, and change of each leaf."""
        (p0, mu0, _, _), (p1, mu1), loss = self.late
        names = self.param_names
        return {"losses": [float(loss)],
                "grad1": self._grad_norms([mu0[k] for k in names], [mu1[k] for k in names]),
                "change": {k: float((p1[k] - p0[k]).norm()) for k in names}}

    def _break(self, fault):
        """A planted fault, for the tests that show a broken run reads not correct."""
        if fault == "state_unchanged":  # a step that returns its state unchanged
            step = self.step
            params = list(self.model.parameters())

            def unchanged(opt_state, gen, batch):
                before = [p.detach().clone() for p in params]
                _, loss = step(opt_state, gen, batch)
                with torch.no_grad():
                    for p, b in zip(params, before):
                        p.copy_(b)
                return opt_state, loss

            self.step = unchanged
        elif fault == "answer":  # the loss altered where it is produced
            step = self.step
            self.step = lambda opt_state, gen, batch: (
                lambda out: (out[0], out[1] * 1.05))(step(opt_state, gen, batch))
        elif fault == "pair":  # the pair altered where it is made: no bias field
            apply = self.generator.apply

            def unbiased(draws, *args, **kwargs):
                draws = {k: (v[0], torch.zeros_like(v[1])) if k.startswith("bias_") and v else v
                         for k, v in draws.items()}
                return apply(draws, *args, **kwargs)

            self.generator.apply = unbiased
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")

    def _labels(self):
        t0 = time.perf_counter()
        batch = next(self.inputs)
        self.label_wait_s += time.perf_counter() - t0
        return [torch.as_tensor(np.asarray(a)).to(self.dev, non_blocking=True) for a in batch]

    def notes(self) -> str:
        return f"seconds waiting on the label stream since set-up: {self.label_wait_s!r}"

    def unit(self, i: int):
        if self.late is None and self.due is not None and time.perf_counter() >= self.due:
            return self._late(i)
        return self._step(i)

    def _step(self, i: int):
        self.opt_state, loss = self.step(self.opt_state, self.gen, self._labels())
        self.guard.push(f"step {i}", loss)
        return loss

    def sync(self):
        self.guard.flush()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def unit_work(self, i: int):
        t = self.cfg["training"]
        return work.train_work(self.cfg["network"], self.in_channels, [t["output_shape"]] * 3,
                               t["batchsize"], self.cfg["compute_dtype"])

    def instrument(self, spans):
        spans.wrap(self, "_labels", "labels")
        spans.wrap(self, "step", "step")
        spans.wrap(self.training, "generate_batch", "generate_batch")

    def end_to_end(self, times, wall):
        return {"train_steps_per_s": len(times) / wall}

    def release(self):
        self.inputs.close()
        del self.step, self.model, self.opt_state
        self.tmp.cleanup()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None):
        """The plain train steps on the program's pairs: (the first steps from
        the seed's weights, the window's checked step from its kept state)."""
        t = self.cfg["training"]
        run = lambda sd, pairs, state=None: ref.train_steps(
            sd, self.param_names, self.cfg["network"], pairs, t["lr"], t["loss_cropping"],
            self.residual, quant=quant, state=state)
        first = run(self.sd0, [r["pair"] for r in self.records[:self.setup_units]])
        late = None
        if self.late is not None:
            sd, mu, nu, count = self.late[0]
            late = run({**self.sd0, **sd}, [self.records[-1]["pair"]], (mu, nu, int(count)))
        return first, late

    def steps_gaps(self, prog, want):
        """(loss, gradient, change) gaps, each the worse of the first steps'
        and the window's checked step's."""
        gaps = [ref.compare(p, w) for p, w in zip(prog, want) if w is not None]
        return tuple(max(g[j] for g in gaps) for j in range(3))

    def pair_gaps(self, q=None) -> dict:
        """Of every checked example: the gaps of its recorded pair to the plain
        generator's, per channel (image channels, then the target)."""
        rows = []
        for rec in self.records:
            image, target = rec["pair"]
            for b, (means, stds) in enumerate(rec["gmm"]):
                draws = rec["draws"][b]
                want_i, want_t = ref_gen.generate(self.ref_settings, rec["labels"][b], means,
                                                  stds, draws, q)
                if q is not None:  # the control: the plain generator rounded, in its place
                    image_b, target_b = ref_gen.generate(self.ref_settings, rec["labels"][b],
                                                         means, stds, draws)
                else:
                    image_b, target_b = image[b], target[b]
                g = ref_gen.gaps(torch.cat([image_b, target_b], -1),
                                 torch.cat([want_i, want_t], -1))
                rows.append({k: [float(x) for x in v] for k, v in g.items()})
        return rows

    def label_gap(self) -> int:
        """Voxels by which each checked label map differs from the closest of
        the maps the benchmark wrote; the largest."""
        worst = 0
        for rec in self.records:
            for lab in rec["labels"]:
                lab = lab.reshape(lab.shape[:3])
                worst = max(worst, min(int((lab != torch.as_tensor(m, device=lab.device))
                                           .sum()) if m.shape == tuple(lab.shape) else lab.numel()
                                       for m in self.maps))
        return worst

    def check(self):
        lim = self.wl["check"]["limits"]
        want = self.reference()
        prog = (self.prog, self.late_numbers() if self.late is not None else None)
        loss, grad, change = self.steps_gaps(prog, want)
        pairs = self.pair_gaps()
        pair = max(max(r["q99"]) for r in pairs)
        self.detail = {"losses": [[p["losses"], w["losses"]] for p, w in zip(prog, want)
                                  if w is not None],
                       "pairs": pairs}
        checks = [("loss_gap", loss, lim["loss_gap"]),
                  ("grad_median_gap", grad, lim["grad_median_gap"]),
                  ("change_gap", change, lim["change_gap"]),
                  ("pair_gap", pair, lim["pair_gap"]),
                  ("label_map_gap", self.label_gap(), lim["label_map_gap"])]
        return checks, sum(not (v <= limit) for _, v, limit in checks)

    def control(self, quant):
        """The numbers of the reference in the program's place, computed
        below its precision: the network in ``quant``, the generator in
        bfloat16."""
        low, want = self.reference(quant), self.reference()
        loss, grad, change = self.steps_gaps(low, want)
        pairs = self.pair_gaps(bf16)
        self.control_detail = {"losses": [[p["losses"], w["losses"]]
                                          for p, w in zip(low, want) if w is not None],
                               "pairs": pairs}
        return {"loss_gap": loss, "grad_median_gap": grad, "change_gap": change,
                "pair_gap": max(max(r["q99"]) for r in pairs)}
