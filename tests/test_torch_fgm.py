"""The port's FGM heatmap and the training batch's FGM inputs against the
JAX package.

The inputs are the synthetic training batch's own ``fgm`` arrays (boxes
projected into the six views, with instance masks), collated at 224x400;
the heatmap is taken on the 50 x 28 latent grid, ``resolution`` given as
(w, h).  The hull test and the truncated corner coordinates make both sides
produce the same masks, so the heatmaps agree to float32 rounding of the
weights (1e-6 absolute).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.data.collate import collate_fn
from dualdiff_tpu.data.synthetic import SyntheticNuScenes
from dualdiff_tpu.data.tokenizer import HashTokenizer
from dualdiff_tpu.ops.fgm import fgm_heatmap as jax_fgm_heatmap
from dualdiff_tpu_torch.ops.fgm import fgm_heatmap
from dualdiff_tpu_torch.runner.conds import prepare_batch


@pytest.fixture(scope="module")
def train_batch():
    cfg = tp.jax_config()
    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    return collate_fn([ds[0], ds[1]], cfg, HashTokenizer(), is_train=True,
                      rng=np.random.default_rng(0))


def test_prepare_batch_carries_the_fgm_inputs(train_batch):
    t = prepare_batch(train_batch, "cpu")
    for k in ("bboxes", "masks", "lidar2image"):
        np.testing.assert_array_equal(t[f"fgm_{k}"].numpy(),
                                      np.asarray(train_batch["fgm"][k]))


def test_fgm_heatmap_matches_jax(train_batch):
    fgm = train_batch["fgm"]
    assert np.asarray(fgm["masks"]).any()
    res = (50, 28)  # (w, h) of the 224x400 latent grid
    want = jax_fgm_heatmap(*(jnp.asarray(fgm[k]) for k in (
        "bboxes", "masks", "lidar2image")), res)
    got = fgm_heatmap(*(torch.as_tensor(np.asarray(fgm[k])) for k in (
        "bboxes", "masks", "lidar2image")), res)
    assert tuple(got.shape) == (2, 6, 28, 50)
    assert float(got.max()) > 0.0  # some box is in view
    tp.assert_close(got, want, rtol=0, atol=1e-6)
