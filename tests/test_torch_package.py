"""Package rules of the port: no JAX and nothing of the JAX package inside
``repro_torch``, one device resolver that refuses to guess, and a parameter
bridge that keeps the JAX tree key for key."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.models import cnn as jcnn
from repro_torch import bridge
from repro_torch import device as device_lib

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20, out          # every module was imported
    assert out[1].strip() == "[]", out[1]


def test_resolver_raises_without_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve()
    assert device_lib.resolve("cpu") == torch.device("cpu")
    # float32 stays full precision on the card (cuDNN defaults to TF32)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_bridge_round_trips_darknet19_key_for_key():
    cfg = jcnn.CNNConfig(name="darknet19", input_size=32)
    init, _ = jcnn.MODEL_REGISTRY["darknet19"]
    jtree = jax.tree.map(np.asarray, jax.jit(init, static_argnums=1)(
        jax.random.PRNGKey(0), cfg))
    ttree = bridge.to_torch(jtree, "cpu")
    want = jax_flatten(jtree)
    got = bridge.flatten(ttree)
    assert list(got) == list(want)            # same keystr names, same order
    back = bridge.flatten(bridge.to_numpy(ttree))
    for key, leaf in want.items():
        assert back[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)
    assert any(k.endswith("['rom']['w_q']") for k in got)
    assert any(k.endswith("['sram']['core']") for k in got)
