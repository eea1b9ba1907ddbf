"""The port's ``fid_score`` tool in its ``--paths`` mode against the JAX
package's ``tools/fid_score.py`` on the same two directories of PIL-written
PNGs (adaptive row filters) and the same seeded Inception weights
(``tests/test_torch_metrics.py``'s ``weights``).  As in
``tests/test_torch_fid_score.py``: activations within 1e-5 of the largest,
scores within 1e-3 relative; most of the time is two scipy sqrtm of
2048 x 2048.
"""

import os

import numpy as np

from tests.test_torch_metrics import (_close, _jax_tool, _scores_equal,
                                      weights)  # noqa: F401 (fixture)
from tests.torch_parity import one_blas_thread  # noqa: F401 (autouse)


def test_fid_score_paths_mode_equals_the_jax_tool(weights, capsys):
    from PIL import Image

    from dualdiff_tpu_torch.tools import fid_score

    rng = np.random.default_rng(0)
    for d, shift in (("a", 0), ("b", 60)):
        os.makedirs(d)
        for i in range(8):  # PIL's PNGs, adaptive row filters
            img = np.clip(rng.integers(0, 200, (90, 160, 3)) + shift, 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(f"{d}/{i}.png")
    jtool = _jax_tool("fid_score")
    extract, size, label = fid_score.build_extractor(device="cpu")
    jextract, _, jlabel = jtool.build_extractor()
    assert label == jlabel == "inception_pool3"
    paths = fid_score._list_images("a")
    assert paths == jtool._list_images("a")
    _close(fid_score.activations_for_paths(paths, extract, size),
           jtool.activations_for_paths(paths, jextract, size))
    got = fid_score.main(["--paths", "a", "b", "--device", "cpu"])
    want = jtool.main(["--paths", "a", "b"])
    _scores_equal(got, want)
    assert "FID[inception_pool3] (8 vs 8 images)" in capsys.readouterr().out
