"""The port's surface against the JAX package's, name by name.

For every module of ``synthsr_tpu/`` (one case each), every public top-level
function or class has a counterpart of the same name in the same module of
``synthsr_tpu_torch/`` (defined there or imported into it), or stands in
``LEFT_OUT`` with its reason.  Every parameter of a function (or field of a
class) that both packages have exists in the port's, or stands in
``LEFT_OUT_PARAMS``.  A JAX PRNG ``key`` is the port's ``torch.Generator``
``gen`` wherever the port's function takes one.  Where a reason names the
port's counterpart (a ``sample_*`` sampler, a function under another name),
the test checks that it exists.

Both packages are read as text with ``ast``: nothing of JAX is imported, and
nothing of the port either.  ``python tests/test_torch_surface.py`` prints the
lists as the Markdown table that ROADMAP.md carries.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "synthsr_tpu")
PORT_PKG = os.path.join(REPO, "synthsr_tpu_torch")

TPU = "TPU workaround"
SAMPLER = "sampler + applier"
PLUMBING = "jit / mesh / vmap / flax / optax plumbing"
CACHE = "XLA compile cache"
RENAMED = "another name in the port"

# "module:name" -> (group, the port's counterpart as "module:name" or a name
# in the same module, or None; why)
LEFT_OUT = {
    "ops/conv_pallas.py:conv3d_cf": (
        TPU, "ops/conv_cf.py:conv3d_cf", "the blocked K5 pallas_call; one entry takes every shape"),
    "ops/conv_pallas.py:conv3d_cf_planes": (
        TPU, "ops/conv_cf.py:conv3d_cf", "the K1 / K2 pallas_call entry"),
    "ops/conv_pallas.py:conv3d_cf_grouped": (
        TPU, "ops/conv_cf.py:conv3d_cf",
        "K3's channel-group chaining; the kernels take two sources"),
    "ops/conv_pallas.py:conv3d_cf_flat": (
        TPU, "ops/conv_cf.py:conv3d_cf", "K4's folded (H*W/128, 128) planes"),
    "ops/conv_pallas.py:conv3d_cf_flat_grouped": (
        TPU, "ops/conv_cf.py:conv3d_cf", "K4's grouped form"),
    "ops/conv_pallas.py:conv3d_cf_wgrad": (
        TPU, "ops/conv_cf.py:conv3d_cf_wgrad", "the K6 / K7 pallas_call entry"),
    "ops/conv_pallas.py:pick_blocks": (TPU, None, "K5's VMEM block picker"),
    "ops/conv_pallas.py:split_group_for": (TPU, None, "K3's channel-group split"),
    "ops/conv_pallas.py:split_flat_group_for": (TPU, None, "K4's channel-group split"),
    "ops/conv_train.py:train_conv_ok": (
        TPU, None, "the Pallas kernels' shape gate; the CUDA kernels take every shape"),
    "ops/interp.py:interpn_packed": (TPU, "interpn", "the lane-packed gather"),
    "ops/interp.py:stencil_warp": (TPU, "transform", "the stencil form of the warp"),
    "ops/shear_warp.py:shear_warp_affine": (
        TPU, "ops/interp.py:transform", "the shear warp; the port always warps jointly trilinear"),
    "ops/shear_warp.py:static_max_disp": (TPU, None, "the shear warp's static halo"),
    "parallel/mesh.py:make_data_mesh": (
        PLUMBING, "data_group", "a device mesh; the port takes a process group"),
    "parallel/mesh.py:batch_sharding": (PLUMBING, "local_slice", "a NamedSharding"),
    "parallel/mesh.py:shard_batch": (PLUMBING, "local_slice", "device_put of a sharded batch"),
    "parallel/mesh.py:replicate": (PLUMBING, None, "device_put of replicated state"),
    "parallel/mesh.py:replicated": (PLUMBING, None, "a replicated NamedSharding"),
    "parallel/mesh.py:host_local_batch_to_global": (
        PLUMBING, "local_slice", "a global jax.Array from host-local shards"),
    "parallel/mesh.py:host_local_stacked_to_global": (
        PLUMBING, "local_slice", "the same for stacked steps"),
    "parallel/halo.py:make_spatial_mesh": (
        PLUMBING, "parallel/mesh.py:spawn", "a device mesh; the port's ranks are processes"),
    "parallel/halo_train.py:local_unet_forward_train": (
        PLUMBING, "models/unet.py:UNet3D", "a shard_map body; UNet3D.forward_train(halo=group)"),
    "train/training.py:keras_decay_schedule": (
        PLUMBING, "utils/finite_guard.py:adam_update", "an optax schedule"),
    "train/training.py:make_optimizer": (
        PLUMBING, "utils/finite_guard.py:adam_update", "an optax Adam"),
    "train/training.py:vmap_examples": (
        PLUMBING, "example_generators",
        "jax.vmap over examples; a loop over per-example generators"),
    "models/discriminator_cf.py:can_fast_disc": (
        TPU, None, "the Pallas shape gate; the critic's kernel paths take every size"),
    "models/discriminator_cf.py:make_fast_disc_apply": (
        PLUMBING, "fast_disc_apply", "a jitted closure"),
    "models/discriminator_cf.py:make_fast_disc_input_grad": (
        PLUMBING, "fast_disc_input_grad", "a jitted closure"),
    "models/unet.py:upsample_nearest": (RENAMED, "upsample2", "channels-first (NCDHW)"),
    "models/unet_cf.py:flip_d_variables": (
        PLUMBING, "flip_d_state_dict", "flax variables; a state dict"),
    "models/unet_cf.py:make_fast_predictor": (
        TPU, "fast_unet_forward", "the two-executable decoder split"),
    "models/unet_cf_train.py:make_fast_train_apply": (
        PLUMBING, "fast_train_forward", "a jitted closure"),
    "cli/predict.py:load_unet_variables": (
        PLUMBING, "models/weights.py:load_unet_weights", "flax init and fill"),
    "synth/augment.py:random_spatial_deformation": (
        SAMPLER, "sample_deformation", "applied by spatial_deformation"),
    "synth/augment.py:random_spatial_deformation_cropped": (
        SAMPLER, "sample_deformation", "applied by spatial_deformation on the crop window"),
    "synth/labels_to_image.py:build_batched_generator": (
        PLUMBING, "build_generator", "jit(vmap) of the generator"),
    "synth/sampling.py:draw_traced": (
        PLUMBING, "draw_value", "a draw inside jit; every port draw is on the device"),
    "utils/misc.py:enable_persistent_compile_cache": (CACHE, None, "no XLA compiles"),
}

# "module:function" -> (JAX parameters the port's lacks, group, counterpart, why)
LEFT_OUT_PARAMS = {
    "ops/conv_train.py:conv3d_cf_train": (
        {"interpret", "want_dx"}, TPU, None,
        "Pallas interpret mode; autograd's needs_input_grad decides dx"),
    "ops/interp.py:integrate_vec": (
        {"max_displacement", "stencil_radius_cap", "runtime_stencil"}, TPU, None,
        "the stencil warp's static halo"),
    "ops/interp.py:transform": ({"packed"}, TPU, None, "the lane-packed gather"),
    "parallel/halo.py:halo_pad": ({"axis_name"}, PLUMBING, None, "a mesh axis; a process group"),
    "parallel/halo.py:sharded_unet_apply": (
        {"variables", "mesh", "axis", "jit"}, PLUMBING, None,
        "flax variables and a mesh; the module and a process group"),
    "parallel/halo_train.py:make_halo_train_step": (
        {"mesh", "axis", "global_x"}, PLUMBING, None, "a mesh; a process group"),
    "train/adversarial.py:gradient_penalty": (
        {"disc_params"}, PLUMBING, None, "flax parameters; disc_apply closes over them"),
    "train/adversarial.py:make_adversarial_steps": (
        {"disc_model", "generate_fn", "gen_opt", "disc_opt", "need_labels", "seg_apply",
         "seg_vars", "seg_eq", "generation_labels", "norm_m", "norm_M", "fast_forward",
         "data_mesh", "with_scan"}, PLUMBING, "train/metrics.py:build_seg_loss_fn",
        "flax modules, optax states, a mesh and scans; the critic, generator, learning rates, "
        "group and seg_loss_fn"),
    "train/adversarial.py:random_weighted_average": (
        {"key", "n_dp", "axis_name"}, SAMPLER, None,
        "the weight w is drawn by the caller from each example's generator"),
    "train/adversarial.py:restore_adv_checkpoint": (
        {"model_dir", "epoch", "template"}, PLUMBING, None, "a flax template; the modules"),
    "train/adversarial.py:save_adv_checkpoint": (
        {"ckpt"}, PLUMBING, None, "a pytree; the modules and optimiser states"),
    "train/training.py:make_train_step": (
        {"generate_fn", "optimizer", "return_labels_to_loss", "fast_forward", "advance_key",
         "data_mesh"}, PLUMBING, None,
        "a jitted step over optax and a mesh; the generator, learning rate and group"),
    "train/training.py:restore_checkpoint": (
        {"model_dir", "epoch", "template"}, PLUMBING, None, "a flax template; the module"),
    "train/training.py:save_checkpoint": (
        {"params", "batch_stats"}, PLUMBING, None, "pytrees; the module"),
    "train/training.py:training": (
        {"fast_forward"}, TPU, None, "the Pallas-or-XLA switch; kernels wherever a card is"),
    "models/autoencoder.py:AutoEncoder3D": (
        {"compute_dtype"}, PLUMBING, None, "a flax field; the port's modules run float32"),
    "models/autoencoder.py:SingleAE": (
        {"compute_dtype"}, PLUMBING, None, "a flax field; the port's modules run float32"),
    "models/unet.py:UNet3D": (
        {"compute_dtype"}, PLUMBING, None, "a flax field; UNet3D.forward's dtype argument"),
    "models/discriminator.py:Discriminator3D": (
        {"stride2_impl"}, TPU, None, "the space-to-depth stride-2 conv"),
    "models/unet_cf.py:fast_unet_forward": (
        {"variables", "interpret", "stop_before_level", "resume_state"}, TPU, None,
        "the two-executable split and interpret mode; the module holds the weights"),
    "synth/augment.py:bias_field_corruption": (
        {"key", "bias_field_std", "bias_scale", "same_bias_for_all_channels", "prob"}, SAMPLER,
        "sample_bias_field", "applied on the drawn field"),
    "synth/augment.py:gaussian_blur": ({"key"}, SAMPLER, "sample_blur_factors",
                                       "applied on the drawn factors"),
    "synth/augment.py:intensity_augmentation": (
        {"key", "noise_std", "gamma_std", "contrast_inversion", "prob_noise", "prob_gamma"},
        SAMPLER, "sample_intensity_augmentation", "applied on the draws"),
    "synth/augment.py:mimic_acquisition": (
        {"noise_std", "prob_noise", "key"}, SAMPLER, "sample_acquisition_noise",
        "applied on the draws (noise=)"),
    "synth/augment.py:random_crop": ({"key"}, SAMPLER, "sample_crop", "applied on crop_idx"),
    "synth/augment.py:random_flip": ({"key", "prob"}, SAMPLER, "sample_flip",
                                     "applied on the flips"),
    "synth/augment.py:sample_conditional_gmm": (
        {"key"}, SAMPLER, "synth/sampling.py:normal", "applied on the N(0, 1) draw"),
    "synth/label_ops.py:mask_edges": (
        {"key", "boundaries", "prob_mask"}, SAMPLER, "sample_mask_edges", "applied on the draws"),
    "synth/label_ops.py:random_dilation_erosion": (
        {"key", "min_factor", "operation"}, SAMPLER, "sample_dilation_erosion",
        "applied on the drawn p and factor"),
    "synth/labels_to_image.py:GenerationConfig": (
        {"exact_warp", "reg_disp_fwd", "reg_disp_inv"}, TPU, None,
        "the shear warp; the port always warps jointly trilinear"),
    "utils/finite_guard.py:guard_updates": (
        {"new_tree", "old_tree"}, PLUMBING, None, "pytrees; lists of tensors"),
}


def _modules():
    out = []
    for root, _, names in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(root, n), JAX_PKG) for n in names
                if n.endswith(".py")]
    return sorted(out)


def _surface(path):
    """Public top-level definitions {name: node}, and the names that imports
    bind at the top level; None when the module does not exist."""
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    defs, imported = {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                defs[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return defs, imported


def _params(node):
    """A function's parameters; a class's ``__init__`` parameters, or its
    annotated fields (a dataclass or a flax module)."""
    if isinstance(node, ast.ClassDef):
        init = next((b for b in node.body
                     if isinstance(b, ast.FunctionDef) and b.name == "__init__"), None)
        if init is None:
            return [b.target.id for b in node.body
                    if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]
        node = init
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return [p for p in names if p != "self"]


def _port_has(module, ref):
    """``ref`` ("module:name" or a name in ``module``) exists in the port."""
    mod, _, name = ref.rpartition(":")
    surface = _surface(os.path.join(PORT_PKG, mod or module))
    return surface is not None and (name in surface[0] or name in surface[1])


@pytest.mark.parametrize("module", _modules())
def test_port_has_the_jax_surface(module):
    jax_defs, _ = _surface(os.path.join(JAX_PKG, module))
    port = _surface(os.path.join(PORT_PKG, module))
    port_defs, port_imported = port if port is not None else ({}, set())
    missing = [n for n in jax_defs if n not in port_defs and n not in port_imported
               and f"{module}:{n}" not in LEFT_OUT]
    assert not missing, f"{module}: no counterpart in the port and not left out: {missing}"

    short = {}
    for name in sorted(set(jax_defs) & set(port_defs)):
        port_params = set(_params(port_defs[name]))
        if "gen" in port_params:
            port_params.add("key")
        lacking = set(_params(jax_defs[name])) - port_params
        listed = LEFT_OUT_PARAMS.get(f"{module}:{name}", (set(),))[0]
        assert listed <= lacking, f"{module}:{name}: listed but present {listed - lacking}"
        if lacking - listed:
            short[name] = sorted(lacking - listed)
    assert not short, f"{module}: parameters the port lacks, not left out: {short}"

    mine = {k: v for k, v in LEFT_OUT.items() if k.startswith(module + ":")}
    mine.update({k: v[1:] for k, v in LEFT_OUT_PARAMS.items() if k.startswith(module + ":")})
    for key, (group, counterpart, why) in mine.items():
        assert group in (TPU, SAMPLER, PLUMBING, CACHE, RENAMED) and why, key
        name = key.split(":")[1]
        assert name in jax_defs, f"{key} is not in the JAX package (stale entry)"
        if key in LEFT_OUT:
            assert not (port is not None and (name in port_defs or name in port_imported)), \
                f"{key} has a counterpart in the port now (stale entry)"
        if counterpart is not None:
            assert _port_has(module, counterpart), f"{key}: no {counterpart} in the port"
        if group == SAMPLER and counterpart is not None:
            assert counterpart.rpartition(":")[2].startswith(("sample_", "normal")), key


def _markdown():
    def code(ref):
        return f"`{ref}`" if ref else "—"

    rows = ["| JAX name | left out of the port | group | the port's counterpart | why |",
            "|---|---|---|---|---|"]
    for key, (group, counterpart, why) in sorted(LEFT_OUT.items()):
        rows.append(f"| `{key}` | the name | {group} | {code(counterpart)} | {why} |")
    for key, (params, group, counterpart, why) in sorted(LEFT_OUT_PARAMS.items()):
        lacking = ", ".join(f"`{p}`" for p in sorted(params))
        rows.append(f"| `{key}` | {lacking} | {group} | {code(counterpart)} | {why} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(_markdown())
