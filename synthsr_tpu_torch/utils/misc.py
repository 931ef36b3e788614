"""Parameter plumbing and host-side sampling helpers: the port's own copy of
the functions it uses from ``synthsr_tpu/utils/misc.py`` (pure Python and
numpy; reference ``ext/lab2im/utils.py:287-399`` reformat helpers,
``:402-421`` get_dims,
``:601-614`` padding margin, ``:821-832`` CLI type inference, ``:835-891``
LoopInfo, ``:894-944`` LUT / divisibility, ``:961-1049``
draw_value_from_distribution).  Each function behaves as its namesake there;
``tests/test_torch_host.py`` holds them equal.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

_NUMERIC = (int, float, np.integer, np.floating)


def load_array_if_path(var, load_as_numpy: bool = True):
    """If ``var`` is a string path to a .npy file, load it (reference utils.py:287)."""
    if isinstance(var, str) and load_as_numpy:
        if not os.path.isfile(var):
            raise FileNotFoundError(f"no such file: {var}")
        var = np.load(var)
    return var


def reformat_to_list(var, length=None, load_as_numpy=False, dtype=None):
    """Coerce scalar/tuple/array/path into a list, optionally broadcast to ``length``.

    Mirrors reference ``utils.reformat_to_list`` (utils.py:319-370).
    """
    if var is None:
        return None
    var = load_array_if_path(var, load_as_numpy=load_as_numpy)
    if isinstance(var, _NUMERIC):
        var = [var]
    elif isinstance(var, (bool, np.bool_)):
        var = [var]
    elif isinstance(var, tuple):
        var = list(var)
    elif isinstance(var, np.ndarray):
        var = [var[0]] if var.shape == (1,) else np.squeeze(var).tolist()
    elif isinstance(var, str):
        var = [var]
    if not isinstance(var, list):
        raise TypeError("var should be an int, float, tuple, list, numpy array, or path")
    if length is not None:
        if len(var) == 1:
            var = var * length
        elif len(var) != length:
            raise ValueError(f"var should have length 1 or {length}, got {len(var)}")
    if dtype is not None:
        cast = {"int": int, "float": float, "bool": bool, "str": str}[dtype]
        var = [cast(v) for v in var]
    return var


def reformat_to_n_channels_array(var, n_dims=3, n_channels=1):
    """Coerce to an (n_channels, n_dims) float array (reference utils.py:373-399)."""
    if var is None:
        return [None] * n_channels
    if isinstance(var, str):
        var = np.load(var)
    if isinstance(var, _NUMERIC) or isinstance(var, (list, tuple)):
        var = np.tile(np.array(reformat_to_list(var, n_dims)), (n_channels, 1))
    elif isinstance(var, np.ndarray):
        if n_channels == 1:
            var = var.reshape((1, n_dims))
        elif np.squeeze(var).shape == (n_dims,):
            var = np.tile(var.reshape((1, n_dims)), (n_channels, 1))
        elif var.shape != (n_channels, n_dims):
            raise ValueError(f"var should be (1,{n_dims}) or ({n_channels},{n_dims})")
    else:
        raise TypeError("var should be int, float, list, tuple or ndarray")
    return np.round(var, 3)


def get_dims(shape, max_channels=10):
    """Infer (n_dims, n_channels) from a volume shape (reference utils.py:402-421)."""
    if shape[-1] <= max_channels:
        return len(shape) - 1, shape[-1]
    return len(shape), 1


def get_padding_margin(cropping, loss_cropping):
    """Per-axis (cropping - loss_cropping)/2 margin (reference utils.py:601-614)."""
    if (cropping is None) or (loss_cropping is None):
        return None
    cropping = reformat_to_list(cropping)
    loss_cropping = reformat_to_list(loss_cropping)
    n_dims = max(len(cropping), len(loss_cropping))
    cropping = reformat_to_list(cropping, length=n_dims)
    loss_cropping = reformat_to_list(loss_cropping, length=n_dims)
    margin = [int((cropping[i] - loss_cropping[i]) / 2) for i in range(n_dims)]
    return margin[0] if len(margin) == 1 else margin


def infer(x):
    """CLI polymorphic string coercion: float, bool, or str (reference utils.py:821-832)."""
    try:
        return float(x)
    except ValueError:
        pass
    if x in ("False", "false"):
        return False
    if x in ("True", "true"):
        return True
    return x


def list_images_in_folder(path_dir, include_single_image=True):
    """Sorted list of volume files in a directory (reference utils.py:296-316)."""
    exts = ("*.nii.gz", "*.nii", "*.mgz", "*.mgh", "*.npz")
    if include_single_image and any(path_dir.endswith(e[1:]) for e in exts):
        if not os.path.isfile(path_dir):
            raise FileNotFoundError(f"file not found: {path_dir}")
        return [path_dir]
    if not os.path.isdir(path_dir):
        raise NotADirectoryError(f"folder not found: {path_dir}")
    files = sorted(sum((glob.glob(os.path.join(path_dir, e)) for e in exts), []))
    if not files:
        raise RuntimeError(f"no image files found in {path_dir}")
    return files


def get_mapping_lut(source, dest=None):
    """LUT mapping label values ``source`` -> ``dest`` (default arange). Ref utils.py:894."""
    source = np.asarray(reformat_to_list(source), dtype=np.int32)
    if dest is None:
        dest = np.arange(source.shape[0], dtype=np.int32)
    else:
        dest = np.asarray(reformat_to_list(dest, dtype="int"), dtype=np.int32)
        if len(source) != len(dest):
            raise ValueError("source and dest must have the same length")
    lut = np.zeros(int(np.max(source)) + 1, dtype=np.int32)
    lut[source] = dest
    return lut


def find_closest_number_divisible_by_m(n, m, answer_type="lower"):
    """Closest multiple of m to n (reference utils.py:928-944)."""
    if n % m == 0:
        return n
    q = int(n / m)
    lower, higher = q * m, (q + 1) * m
    if answer_type == "lower":
        return lower
    if answer_type == "higher":
        return higher
    if answer_type == "closer":
        return lower if (n - lower) < (higher - n) else higher
    raise ValueError(f"answer_type should be lower/higher/closer, got {answer_type}")


class LoopInfo:
    """Progress printer with ETA (reference utils.py:835-891 semantics)."""

    def __init__(self, n_iterations, spacing=10, text="processing", print_time=False):
        self.n_iterations = n_iterations
        self.spacing = spacing
        self.text = text
        self.print_time = print_time
        self.start = time.time()

    def update(self, idx):
        if idx == 0:
            print(f"{self.text} 1/{self.n_iterations}")
        elif idx % self.spacing == self.spacing - 1:
            msg = f"{self.text} {idx + 1}/{self.n_iterations}"
            if self.print_time:
                elapsed = time.time() - self.start
                eta = elapsed / (idx + 1) * (self.n_iterations - idx - 1)
                msg += f"  remaining time: {int(eta // 60)}min{int(eta % 60)}s"
            print(msg)


def draw_value_from_distribution(hyperparameter, size=1, distribution="uniform",
                                 centre=0.0, default_range=10.0, positive_only=False,
                                 rng: np.random.Generator | None = None):
    """Host-side hyperprior sampling (reference utils.py:961-1049, numpy path).

    ``hyperparameter`` may be False (returns None), None (U(centre±default_range)),
    a number h (U(centre±h)), a length-2 sequence [a, b], a (2, m) array, or a
    (2n, m) array from which one 2-row modality block is picked at random.
    """
    if hyperparameter is False:
        return None
    rand = rng if rng is not None else np.random
    hyperparameter = load_array_if_path(hyperparameter, load_as_numpy=True)
    if not isinstance(hyperparameter, np.ndarray):
        if hyperparameter is None:
            hyperparameter = np.array([[centre - default_range] * size,
                                       [centre + default_range] * size])
        elif isinstance(hyperparameter, _NUMERIC):
            hyperparameter = np.array([[centre - hyperparameter] * size,
                                       [centre + hyperparameter] * size])
        elif isinstance(hyperparameter, (list, tuple)):
            if len(hyperparameter) != 2:
                raise ValueError("if list, hyperparameter must have length 2")
            hyperparameter = np.tile(np.array(hyperparameter)[:, None], (1, size))
        else:
            raise ValueError("hyperparameter should be None, a number, a sequence, or an array")
    else:
        if hyperparameter.shape[0] % 2:
            raise ValueError("hyperparameter rows must be divisible by 2")
        n_mod = hyperparameter.shape[0] // 2
        idx = 2 * int(rand.integers(n_mod) if rng is not None else np.random.randint(n_mod))
        hyperparameter = hyperparameter[idx: idx + 2, :]

    if distribution == "uniform":
        value = (rand.uniform(hyperparameter[0, :], hyperparameter[1, :])
                 if rng is not None else
                 np.random.uniform(low=hyperparameter[0, :], high=hyperparameter[1, :]))
    elif distribution == "normal":
        value = (rand.normal(hyperparameter[0, :], hyperparameter[1, :])
                 if rng is not None else
                 np.random.normal(loc=hyperparameter[0, :], scale=hyperparameter[1, :]))
    else:
        raise ValueError("distribution should be 'uniform' or 'normal'")
    if positive_only:
        value = np.maximum(value, 0)
    return value
