"""Model factories the port's engine-worker processes load BY FILE PATH
(serving/worker.py resolve_factory's `/path/file.py:callable` form), the
port's twin of tests/worker_factories.py.  They import the port and
numpy only: a worker must never import jax or the JAX package.

NOT a test module: no test_ prefix, collected by nothing.
"""

import json
import sys
import time

import numpy as np


def save_params(path, params):
    """Write a flax param tree (nested dicts of numpy leaves) as an .npz,
    its keys the leaves' "/"-joined paths."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(params, ())
    np.savez(path, **flat)


def _load_params(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def npz_lm_factory(params, cfg, device="cpu"):
    """The port's f32 decode-mode TransformerLM of config `cfg` (a JSON
    object string or dict) holding the params the test saved at
    `params` (save_params)."""
    import torch

    from container_engine_accelerators_tpu_torch.models import convert
    from container_engine_accelerators_tpu_torch.models import generate as G

    cfg = json.loads(cfg) if isinstance(cfg, str) else dict(cfg)
    model = G.make_decoder(dtype=torch.float32, device=device, **cfg)
    return convert.load_flax_params(model, _load_params(params))


def modules_probe_factory(out, **kw):
    """The port's transformer_lm_factory(**kw), after writing the jax and
    JAX-package modules this worker has imported (a JSON list) to
    `out`."""
    from container_engine_accelerators_tpu_torch.serving.worker import (
        transformer_lm_factory,
    )

    model = transformer_lm_factory(**kw)
    bad = sorted(
        k for k in sys.modules
        if k == "jax" or k.startswith("jax.") or k == "flax"
        or k.split(".")[0] == "container_engine_accelerators_tpu"
    )
    with open(out, "w") as f:
        json.dump(bad, f)
    return model


def hang_factory(**kw):
    """Never returns: the handshake-timeout fixture."""
    del kw
    while True:
        time.sleep(3600)


def boom_factory(**kw):
    """Raises at build: the boot_failed handshake fixture."""
    del kw
    raise RuntimeError("boom_factory exploded (as designed)")
