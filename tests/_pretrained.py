"""Shared by tests/test_torch_port_registry.py and
tests/test_torch_port_trellis_fp32.py: a pretrained directory in the
reference's layout, written by the JAX package's registry from seeded
random parameters."""

import json
import os

import jax
import numpy as np

from gvfdiffusion_tpu.models import registry as jr


def random_params(shapes, seed):
    """A flax tree of `init`'s shapes, every leaf drawn non-zero from a
    numpy seed (the flax inits zero the modulations and output layers,
    which would hide any fault): kernels N(0, 1/fan_in), biases N(0, 0.1^2),
    LayerNorm scales and RMS gammas 1 + N(0, 0.1^2), others N(0, 1)."""
    r = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(path[-1].key)
        a = r.standard_normal(v.shape).astype(np.float32)
        if name in ("scale", "gamma"):
            return 1.0 + 0.1 * a
        if name == "bias":
            return 0.1 * a
        if name == "kernel":
            return a / np.sqrt(np.prod(v.shape[:-1]))
        return a
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def write_model(root, key, name, args, jax_inputs, seed):
    """JAX builds `name` from the release-style `args`; its parameters
    (drawn as random_params from `init`'s shapes on `jax_inputs`) go to
    <root>/<key>.npz beside <key>.json. Returns (JAX model, params)."""
    model = jr.create_model(name, **args)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *jax_inputs)
    params = random_params(shapes, seed)
    jr.save_params_npz(params, os.path.join(root, f"{key}.npz"))
    with open(os.path.join(root, f"{key}.json"), "w") as f:
        json.dump({"name": name, "args": args}, f)
    return model, params
