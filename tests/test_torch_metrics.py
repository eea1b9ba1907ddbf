"""The port's FID and FVD (``dualdiff_tpu_torch/metrics``,
``tools/fvd_score.py``; ``tools/fid_score.py`` in
``tests/test_torch_fid_score.py``) against the JAX package's.

Weights: the JAX Inception's variables, seeded (``tp.random_params`` over
its shapes; BatchNorm means N(0, 0.1^2), variances U(0.5, 1.5)), carried
to the port through ``dualdiff_tpu.metrics.fid_import.export_pt_inception``
and the port's strict loader; for I3D a seeded state dict under
``i3d_key_list()``, imported by each side.  The tools read the same files
(``pretrained/pt_inception-2015-12-05.pth``, ``i3d_pretrained_400.pt``)
from the working directory.

Tolerances, float32 on the CPU: Inception's pool3 and I3D's logits and
pooled features within 1e-5 of the largest value (3e-7 read); the Frechet
distance, ``clip_features_from_frames`` and ``fvd_from_features`` on the
same arrays exactly (the same numpy and scipy code).  The tools' scores
within 1e-3 relative (FID over a few images has a rank-deficient 2048 x
2048 covariance, whose sqrtm magnifies the activations' last bits): the
activations they score are held at 1e-5 first, and the pairing exactly.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from tests.torch_parity import one_blas_thread  # noqa: F401 (autouse)
from dualdiff_tpu_torch.metrics import fid as port_fid
from dualdiff_tpu_torch.metrics.fid_import import (
    PT_INCEPTION_CONV_MODULES, export_pt_inception, import_pt_inception,
    load_pt_inception, pt_inception_key_list)
from dualdiff_tpu_torch.metrics.fvd import (clip_features_from_frames,
                                            fvd_from_features)
from dualdiff_tpu_torch.metrics.i3d import (I3D_CONV_UNITS, InceptionI3d,
                                            i3d_key_list, import_i3d,
                                            load_i3d)

REPO = os.path.join(os.path.dirname(__file__), "..")
ACT_TOL = 1e-5  # of the largest activation
SCORE_RTOL = 1e-3
CAMS = ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
        "CAM_BACK", "CAM_BACK_LEFT"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol=ACT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _inception_sd(seed=0):
    """Seeded JAX Inception variables -> pytorch-fid names through the JAX
    exporter (numpy)."""
    import jax
    import jax.numpy as jnp
    from dualdiff_tpu.metrics.fid import InceptionV3 as JaxInception
    from dualdiff_tpu.metrics.fid_import import export_pt_inception as jexp

    shapes = jax.eval_shape(JaxInception().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.normal(0, 0.1, s.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, s.shape)).astype(np.float32),
        shapes["batch_stats"])
    return jexp({"params": tp.random_params(shapes["params"], seed),
                 "batch_stats": stats})


def _i3d_sd(seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in InceptionI3d().state_dict().items():
        s = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif k.endswith("conv3d.weight"):
            sd[k] = (rng.standard_normal(s) / np.sqrt(np.prod(s[1:]))) \
                .astype(np.float32)
        elif k.endswith(("running_var", "bn.weight")):
            sd[k] = rng.uniform(0.5, 1.5, s).astype(np.float32)
        else:
            sd[k] = rng.normal(0, 0.1, s).astype(np.float32)
    return sd


# ---------------------------------------------------------------- modules --

def test_inception_equals_the_jax_module():
    """Two seeded 299 x 299 images, NHWC and NCHW, against the JAX module
    on the weights the JAX importer reads back from the same dict."""
    import jax
    import jax.numpy as jnp
    from dualdiff_tpu.metrics.fid import InceptionV3 as JaxInception
    from dualdiff_tpu.metrics.fid_import import import_pt_inception as jimp

    sd = _inception_sd()
    x = np.random.default_rng(5).random((2, 299, 299, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxInception().apply)(jimp(sd), jnp.asarray(x)))
    model = port_fid.InceptionV3()
    load_pt_inception(model, sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got_nchw = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (2, 2048)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), got_nchw.numpy())


def test_pt_inception_import_export_round_trip():
    """The key list and the synthetic round trip of
    ``tests/test_metrics.py``: the module's state dict is the canonical
    list less ``fc``; export -> (+ fc) -> import gives the same tensors;
    an unknown or a missing key fails loudly."""
    from dualdiff_tpu.metrics.fid_import import \
        pt_inception_key_list as jax_keys

    keys = pt_inception_key_list()
    assert keys == jax_keys() and len(keys) == 94 * 6 + 2
    assert len(PT_INCEPTION_CONV_MODULES) == 94
    model = port_fid.InceptionV3()
    assert set(model.state_dict()) == set(keys) - {"fc.weight", "fc.bias"}
    sd = export_pt_inception(model)
    assert set(sd) | {"fc.weight", "fc.bias"} == set(keys)
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    back = import_pt_inception(sd)
    own = model.state_dict()
    assert set(back) == set(own)
    for k in own:
        assert torch.equal(back[k], own[k]), k
    bad = dict(sd)
    bad["Mixed_9z.conv.weight"] = torch.zeros(1, 1, 1, 1)
    with pytest.raises(AssertionError, match="unconsumed"):
        import_pt_inception(bad)
    bad = dict(sd)
    del bad["Mixed_7c.branch_pool.conv.weight"]
    with pytest.raises(AssertionError, match="missing"):
        import_pt_inception(bad)


def test_i3d_equals_the_jax_module():
    """One 16 x 64 x 64 clip: logits (1, 400) and pooled (1, 1024) against
    the JAX I3D on the same seeded state dict; the key list, 57 BN units,
    12.3M parameters; a renamed key fails."""
    import jax
    import jax.numpy as jnp
    from dualdiff_tpu.metrics.i3d import InceptionI3d as JaxI3d
    from dualdiff_tpu.metrics.i3d import i3d_key_list as jax_keys
    from dualdiff_tpu.metrics.i3d import import_i3d as jimp

    assert i3d_key_list() == jax_keys() and len(I3D_CONV_UNITS) == 57
    sd = _i3d_sd()
    assert set(sd) == set(i3d_key_list())
    x = np.random.default_rng(6).uniform(-1, 1, (1, 16, 64, 64, 3)) \
        .astype(np.float32)
    wl, wp = jax.jit(JaxI3d().apply)(jimp(sd), jnp.asarray(x))
    model = InceptionI3d()
    load_i3d(model, sd)
    n = sum(p.numel() for p in model.parameters())
    assert 12e6 < n < 13e6, n
    with torch.no_grad():
        gl, gp = model(torch.from_numpy(x))
    assert gl.shape == (1, 400) and gp.shape == (1, 1024)
    _close(gl.numpy(), np.asarray(wl))
    _close(gp.numpy(), np.asarray(wp))
    bad = dict(sd)
    bad["Mixed_9z.b0.conv3d.weight"] = bad.pop("Mixed_5c.b0.conv3d.weight")
    with pytest.raises(AssertionError):
        import_i3d(bad)


def test_frechet_and_fvd_equal_the_jax_functions():
    from dualdiff_tpu.metrics import fid as jfid
    from dualdiff_tpu.metrics import fvd as jfvd

    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(300, 16)), rng.normal(size=(300, 16)) * 1.3 + .2
    assert port_fid.fid_from_activations(a, b) == \
        jfid.fid_from_activations(a, b)
    stats = port_fid.compute_statistics(a) + port_fid.compute_statistics(b)
    assert port_fid.frechet_distance(*stats) == jfid.frechet_distance(*stats)
    assert abs(port_fid.fid_from_activations(a, a)) < 1e-6
    frames = rng.normal(size=(40, 8, 16))
    near = frames + rng.normal(size=frames.shape) * 0.05
    f0 = clip_features_from_frames(frames)
    np.testing.assert_array_equal(f0, jfvd.clip_features_from_frames(frames))
    f1 = clip_features_from_frames(near)
    assert fvd_from_features(f0, f1) == jfvd.fvd_from_features(f0, f1)
    scrambled = clip_features_from_frames(frames[:, rng.permutation(8)])
    assert fvd_from_features(f0, f1) < fvd_from_features(f0, scrambled)


# ------------------------------------------------------------------ tools --

@pytest.fixture()
def weights(tmp_path, monkeypatch):
    """``pretrained/`` with the seeded Inception and I3D files, the working
    directory."""
    os.makedirs(tmp_path / "pretrained")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in _inception_sd().items()},
               tmp_path / "pretrained" / "pt_inception-2015-12-05.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _i3d_sd().items()},
               tmp_path / "pretrained" / "i3d_pretrained_400.pt")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _scores_equal(got, want):
    assert np.isfinite(got) and np.isfinite(want)
    assert abs(got - want) <= SCORE_RTOL * abs(want), (got, want)


def _write_clips(root, shift, n=3, frames=6, hw=32, folders=False):
    from dualdiff_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(int(shift * 100))
    os.makedirs(root)
    for i in range(n):
        clip = ((rng.random((frames, hw, hw, 3)) * 0.5 + shift).clip(0, 1)
                * 255).astype(np.uint8)
        if folders:
            os.makedirs(os.path.join(root, f"c{i}"))
            for t, f in enumerate(clip):
                write_png(os.path.join(root, f"c{i}", f"{t:03d}.png"), f)
        else:
            np.savez(os.path.join(root, f"c{i}.npz"), frames=clip)


@pytest.mark.parametrize("path", ["i3d_logits", "i3d_pool", "fallback"])
def test_fvd_score_equals_the_jax_tool(weights, path, capsys):
    """npz clips against frame folders; I3D's logits and pooled features,
    and without I3D the frame-feature statistics over the same Inception
    (the projection to 512 included)."""
    from dualdiff_tpu_torch.tools import fvd_score

    _write_clips("real", 0.2)
    _write_clips("gen", 0.3, folders=True)
    args = ["--real", "real", "--gen", "gen", "--frames", "4", "--size",
            "48"]
    if path == "fallback":
        args += ["--i3d", "nowhere.pt"]
    else:
        args += ["--feature", path.split("_")[1]]
    np.testing.assert_array_equal(fvd_score.load_clips("gen", 4, 48),
                                  _jax_tool("fvd_score").load_clips(
                                      "gen", 4, 48))
    got = fvd_score.main(args + ["--device", "cpu"])
    want = _jax_tool("fvd_score").main(args)
    _scores_equal(got, want)
    label = "fallback(inception_pool3)+proj512" if path == "fallback" \
        else path
    assert f"FVD[{label}] (3 real vs 3 generated clips, 4 frames)" in \
        capsys.readouterr().out


# ------------------------------------------------------------------- card --

@pytest.mark.cuda
def test_inception_on_the_card_equals_the_cpu():
    """Pool3 of 16 seeded images on the card (float32, TF32 off) within
    1e-4 of the largest activation of the same model on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = port_fid.seeded_init_(port_fid.InceptionV3(), 0)
    x = torch.rand(16, 3, 299, 299, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x).numpy()
        got = model.cuda()(x.cuda()).cpu().numpy()
    _close(got, want, 1e-4)
