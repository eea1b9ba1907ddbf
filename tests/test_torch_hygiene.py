"""Rules of the port: no JAX anywhere in it, and no silent CPU fallback."""

import ast
import os

import pytest
import torch

from tests import torch_parity as tp

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "flax", "optax", "dualdiff_tpu")
# packages the card is not promised: the port reads and writes its images,
# configs, checkpoints and logs without them
OPTIONAL = ("PIL", "cv2", "yaml", "h5py", "tensorboardX", "orbax",
            "safetensors", "transformers")
# the lazy imports of the copied data modules, for the nuScenes reader's
# inputs (ROADMAP Queue 1 #6): the one place each may stay
LAZY = {os.path.join("data", "collate.py"): {"PIL"},
        os.path.join("data", "bev_raster.py"): {"cv2"}}


def _port_files():
    pkg = os.path.join(ROOT, "dualdiff_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_port_files())
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_port_imports_no_optional_package():
    """PIL, cv2, PyYAML, h5py, tensorboardX, orbax, safetensors and
    transformers: in no module of the port, the entry points and tools
    included, but for the copied data modules' lazy imports (``LAZY``)."""
    pkg = os.path.join(ROOT, "dualdiff_tpu_torch")
    for path in _port_files():
        allowed = LAZY.get(os.path.relpath(path, pkg), set())
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in OPTIONAL or top in allowed, \
                f"{path} imports {mod}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from dualdiff_tpu_torch import resolve_device
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.factory import build_models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tp.port_config(tp.TINY_OVERRIDES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_models(cfg, tiny=True)
    models = build_models(cfg, tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BEVControlNetPipeline(cfg, models)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_what_the_kernel_cannot_take():
    """Checks run before any launch: a CUDA-less machine still reaches
    them through a non-CPU tensor (meta) and gets an error, never the plain
    version."""
    from dualdiff_tpu_torch.ops import attention as A

    q = torch.empty(2, 512, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        A.packed_attention_fwd(q, q, q, heads=8)
    with pytest.raises(ValueError, match="CUDA"):
        A.packed_attention_nbr_fwd(q, q, q, heads=8, n_cam=2)
    with pytest.raises(ValueError, match="CUDA"):
        A.packed_attention_capped_fwd(q, q, q, heads=8)
    assert A.packed_attention_fwd.launches == 0
    assert A.packed_attention_capped_fwd.launches == 0
