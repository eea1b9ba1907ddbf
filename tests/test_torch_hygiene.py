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
            "safetensors", "transformers", "nuscenes")
# the lazy imports of the data modules, for the nuScenes reader's inputs:
# the one place each may stay, inside the function that reads them
LAZY = {os.path.join("data", "collate.py"): {"PIL"},
        os.path.join("data", "bev_raster.py"): {"cv2"},
        os.path.join("data", "nuscenes.py"): {"PIL", "h5py"}}
# the nuscenes-devkit's map expansion, for the reader's live raster, and
# the devkit (with h5py for the cache) of the offline prep tools
DEVKIT = {os.path.join("data", "nuscenes.py"): {"nuscenes"},
          os.path.join("tools", "create_data.py"): {"nuscenes"},
          os.path.join("tools", "prepare_map_aux.py"): {"h5py", "nuscenes"}}


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


def test_torch_distributed_is_imported_only_under_parallel():
    """The process group and its collectives live in ``parallel/mesh.py``:
    the trainer, the pipeline and the train tool reach them through it,
    and ``parallel/`` is among the files the JAX rule above walks."""
    pkg = os.path.join(ROOT, "dualdiff_tpu_torch")
    files = list(_port_files())
    mesh = os.path.join(pkg, "parallel", "mesh.py")
    assert mesh in files
    users = set()
    for path in files:
        text = open(path).read()
        mods = set(_imports(path))
        dist = {m for m in mods if m.startswith("torch.distributed")}
        tree = ast.parse(text, path)
        dist |= {f"torch.{a.name}" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module == "torch"
                 for a in n.names if a.name == "distributed"}
        under = os.path.relpath(path, pkg).startswith("parallel" + os.sep)
        assert not dist or under, f"{path} imports {sorted(dist)}"
        if "parallel.mesh" in mods or any(
                isinstance(n, ast.ImportFrom) and n.level and
                (n.module or "").endswith("parallel.mesh")
                for n in ast.walk(tree)):
            users.add(os.path.relpath(path, pkg))
    assert {os.path.join("runner", "trainer.py"),
            os.path.join("pipeline", "bev_controlnet.py"),
            os.path.join("tools", "train.py")} <= users, users


def test_port_imports_no_optional_package():
    """PIL, cv2, PyYAML, h5py, tensorboardX, orbax, safetensors and
    transformers: in no module of the port, the entry points and tools
    included, but for the copied data modules' lazy imports (``LAZY``)."""
    pkg = os.path.join(ROOT, "dualdiff_tpu_torch")
    for path in _port_files():
        rel = os.path.relpath(path, pkg)
        allowed = LAZY.get(rel, set()) | DEVKIT.get(rel, set())
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in OPTIONAL or top in allowed, \
                f"{path} imports {mod}"


def test_optional_imports_stay_inside_functions():
    """``LAZY`` and ``DEVKIT``'s imports run only in the branch that reads
    with them: none at a module's top level, so every module imports on
    the card, where h5py and the devkit are absent."""
    pkg = os.path.join(ROOT, "dualdiff_tpu_torch")
    for rel, names in {**LAZY, **DEVKIT}.items():
        tree = ast.parse(open(os.path.join(pkg, rel)).read(), rel)
        inside = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        found = set()
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) and node.level == 0 else []
            for mod in mods:
                if mod.split(".")[0] in names | set(LAZY.get(rel, ())):
                    found.add(mod.split(".")[0])
                    assert id(node) in inside, f"{rel}: {mod} at top level"
        assert found == LAZY.get(rel, set()) | DEVKIT.get(rel, set()), rel


def test_no_port_module_opens_builds_or_loads_native():
    """The JAX package's ``native/`` (its Makefile, source and committed
    library) is neither named, built (``make``) nor loaded by the port:
    ``data/native.py`` compiles its own copy of the source into
    ``build/dualdiff_tpu_torch/``."""
    for path in _port_files():
        text = open(path).read()
        tree = ast.parse(text, path)
        strings = [n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value,
                                                                 str)]
        for s in strings:
            assert "libdualdiff_native" not in s, path
            assert not s.startswith(("native/", "make -C")), \
                f"{path}: {s!r}"
        for node in ast.walk(tree):
            # no command line that runs make, no path joined onto native/
            if isinstance(node, (ast.List, ast.Tuple)) and node.elts \
                    and isinstance(node.elts[0], ast.Constant):
                assert node.elts[0].value != "make", path
            if isinstance(node, ast.Call) and getattr(
                    node.func, "attr", None) == "join":
                assert not any(isinstance(a, ast.Constant)
                               and a.value in ("native", "native/")
                               for a in node.args), path


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
