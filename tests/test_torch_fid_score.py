"""The port's ``fid_score`` tool (``dualdiff_tpu_torch/tools/fid_score.py``)
against the JAX package's ``tools/fid_score.py``: the config mode here, the
``--paths`` mode in ``tests/test_torch_fid_paths.py``, on the same
directories and the same seeded Inception weights
(``tests/test_torch_metrics.py``'s ``weights``: the working directory's
``pretrained/``).  The activations each tool scores are held within 1e-5
of the largest, the pairing exactly, and the scores within 1e-3 relative
(a few images give a rank-deficient 2048 x 2048 covariance whose sqrtm
magnifies the activations' last bits).  Most of the time is scipy's sqrtm
of 2048 x 2048, one for each score.
"""

import functools
import os

import numpy as np
import pytest

from tests.test_torch_metrics import (CAMS, _close, _jax_tool,
                                      _scores_equal,
                                      weights)  # noqa: F401 (fixture)


def test_fid_score_config_mode_equals_the_jax_tool(weights, capsys):
    """Token x sensor pairing over a synthetic val split: real 800 x 450
    JPEGs under the dataset root (``augment2d.resize`` 0.5, so the same
    225 x 400 before the crop as nuScenes' 1600 x 900 at 0.25), generated
    PNGs under ``fid.rootb`` (token naming), the train-matching transform
    on both sides, the activations held first; one missing twin is
    skipped by both, refused under ``require_all``."""
    from PIL import Image

    from dualdiff_tpu_torch.data.wrappers import build_dataset
    from dualdiff_tpu_torch.tools import fid_score
    from dualdiff_tpu_torch.utils.config import compose
    from dualdiff_tpu_torch.utils.image_io import write_png

    words = ["dataset=Nuscenes_synthetic", "dataset.num_samples=2",
             "dataset.dataset_root=nusc", "fid.rootb=gen",
             "dataset.augment2d.resize=[[0.5, 0.5]]"]
    ds = build_dataset(compose(words)[0], "val", load_images=False,
                       load_bev=False)
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:450, 0:800]
    for i in range(len(ds)):
        s = ds[i]
        for c, (cam, fname) in enumerate(zip(CAMS, s["filenames"])):
            base = np.stack([128 + 90 * np.sin(xx / (20.0 + 5 * c) + k)
                             * np.cos(yy / 15.0) for k in range(3)], -1)
            noise = rng.normal(0, 12, (450, 800, 3))
            p = os.path.join("nusc", fname)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            Image.fromarray(np.clip(base + noise, 0, 255).astype(
                np.uint8)).save(p, quality=90)
            g = os.path.join("gen", cam, f"{s['token']}_{cam}.png")
            os.makedirs(os.path.dirname(g), exist_ok=True)
            write_png(g, np.clip(base * 0.8 + 20 + noise, 0, 255)
                      .astype(np.uint8))
    jtool = _jax_tool("fid_score")
    cfg, _ = compose(words)
    reals, gens = fid_score.pair_real_generated(ds, CAMS, "nusc", "gen")
    transform = functools.partial(fid_score.train_matching_transform,
                                  resize_ratio=0.5, target_hw=(224, 400))
    jtransform = functools.partial(jtool.train_matching_transform,
                                   resize_ratio=0.5, target_hw=(224, 400))
    extract, size, _ = fid_score.build_extractor(device="cpu")
    jextract, _, _ = jtool.build_extractor()
    for paths in (reals, gens):
        _close(fid_score.activations_for_paths(paths, extract, size,
                                               transform=transform),
               jtool.activations_for_paths(paths, jextract, size,
                                           transform=jtransform))
    got = fid_score.main(["--device", "cpu",
                          "+exp=dual_branch_augloss_fusion"] + words)
    want = jtool.main(["+exp=dual_branch_augloss_fusion"] + words)
    _scores_equal(got, want)
    assert "(12 real vs 12 generated, token x sensor paired)" in \
        capsys.readouterr().out

    os.remove(os.path.join("gen", "CAM_BACK", f"{ds[1]['token']}_CAM_BACK"
                           ".png"))
    pairs = fid_score.pair_real_generated(ds, CAMS, "nusc", "gen")
    assert pairs == jtool.pair_real_generated(ds, CAMS, "nusc", "gen")
    assert len(pairs[0]) == 11
    with pytest.raises(FileNotFoundError):
        fid_score.pair_real_generated(ds, CAMS, "nusc", "gen",
                                      require_all=True)
    # the bottom-centre crop (the reference's misnamed top_center_crop)
    img = np.arange(100, dtype=np.uint8).reshape(10, 10).repeat(3) \
        .reshape(10, 10, 3)
    np.testing.assert_array_equal(
        fid_score.top_center_crop(img, (4, 6)),
        np.asarray(jtool.top_center_crop(Image.fromarray(img), (4, 6))))
    np.testing.assert_array_equal(
        fid_score.train_matching_transform(img, 0.5, (8, 8)),
        np.asarray(jtool.train_matching_transform(Image.fromarray(img), 0.5,
                                                  (8, 8))))


def test_fid_score_without_weights_labels_and_refuses(tmp_path, monkeypatch,
                                                      capsys):
    """No weights file: a seeded random Inception labelled as such, with
    its warning; real data refused unless ``allow_fallback_assets``."""
    from dualdiff_tpu_torch.tools import fid_score

    monkeypatch.chdir(tmp_path)
    _, _, label = fid_score.build_extractor(device="cpu")
    assert label == "inception_random"
    assert "weights not found" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="allow_fallback_assets"):
        fid_score.build_extractor(require_real=True, device="cpu")


