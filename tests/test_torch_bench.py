"""The port's bench pieces on the CPU: the kernel FLOP recorder against the
JAX package's (traced only on the JAX side), the torch FLOP count, the
card table, the numerics pin, the overlay map and the one-line merge of
``dualdiff_tpu_torch/bench.py`` against ``bench.py``'s."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.ops import attention as JA
from dualdiff_tpu_torch import bench
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.utils import flops as F
from dualdiff_tpu_torch.utils.config import VARIANTS, load_config
from dualdiff_tpu_torch.utils.pins import check_pin, output_stats, save_pin

# b x lq x lk at c = heads x d: tiny, d % 8 == 0, under the TPU score cap
b, LQ, LK, HEADS, D = 2, 128, 96, 4, 8
C = HEADS * D


def _port(fn, *shapes, grad=False):
    """The FLOPs the port's recorder takes from ``fn`` on seeded CPU
    tensors of ``shapes`` (backward too with ``grad``)."""
    gen = torch.Generator().manual_seed(0)
    ts = [torch.randn(*s, generator=gen, requires_grad=grad) for s in shapes]
    with A.recorded_kernel_flops() as rec:
        out = fn(*ts)
        if grad:
            out.sum().backward()
    return rec.total


def _jax(fn, *shapes, grad=False):
    """JAX's ``recorded_kernel_flops`` of ``fn`` (its gradient with
    ``grad``) on zeros of ``shapes``: a trace, nothing runs."""
    args = [jnp.zeros(s, jnp.float32) for s in shapes]
    if grad:
        f = fn
        fn = jax.grad(lambda *a: jnp.sum(f(*a)), argnums=(0, 1, 2))
    return JA.recorded_kernel_flops(fn, *args)


S = D ** -0.5
PACKED = ((b, LQ, C), (b, LK, C), (b, LK, C))
SELF = ((b * 3, LQ, C),) * 3  # the ring: 3 cameras
SPLIT = ((b, LQ, HEADS, D), (b, LK, HEADS, D), (b, LK, HEADS, D))
CASES = {
    # wrapper(s): (port call, JAX call, shapes, under grad)
    "packed_attention_fwd": (
        lambda q, k, v: A.packed_attention_fwd(q, k, v, HEADS),
        lambda q, k, v: JA._packed_infer(q, k, v, S, HEADS, (LQ, LK)),
        PACKED, False),
    "packed_attention_capped_fwd": (
        lambda q, k, v: A.packed_attention_capped_fwd(q, k, v, HEADS),
        lambda q, k, v: JA._packed_infer_capped(q, k, v, S, HEADS,
                                                (LQ, LK)),
        PACKED, False),
    "packed_attention_nbr_fwd": (
        lambda q, k, v: A.packed_attention_nbr_fwd(q, k, v, HEADS, 3),
        lambda q, k, v: JA._flash_packed_nbr(q, k, v, S, HEADS, 3,
                                             (LQ, LQ)),
        SELF, False),
    "packed_attention_lse_fwd": (
        lambda q, k, v: A.packed_attention_lse_fwd(q, k, v, HEADS)[0],
        lambda q, k, v: JA._packed_train_t_fwd(q, k, v, S, HEADS,
                                               (LQ, LK))[0],
        PACKED, False),
    "packed_attention_capped_lse_fwd": (
        lambda q, k, v: A.packed_attention_capped_lse_fwd(q, k, v, HEADS)[0],
        lambda q, k, v: JA._packed_train_t_fwd(q, k, v, S, HEADS,
                                               (LQ, LK))[0],
        PACKED, False),
    # PackedAttention: the lse forward, dq and dk/dv, against the custom
    # VJP's forward and backward
    "packed_attention_lse_fwd+bwd_dq+bwd_dkv": (
        lambda q, k, v: A.PackedAttention.apply(q, k, v, HEADS, S),
        lambda q, k, v: JA._flash_packed(q, k, v, S, HEADS, (LQ, LK)),
        PACKED, True),
    "flash_attention_fwd": (
        lambda q, k, v: A.flash_attention_fwd(q, k, v),
        lambda q, k, v: JA.flash_attention(q, k, v),
        SPLIT, False),
    "flash_attention_lse_fwd+bwd_dq+bwd_dkv": (
        lambda q, k, v: A.flash_attention(q, k, v),
        lambda q, k, v: JA.flash_attention(q, k, v),
        SPLIT, True),
    "mha_einsum (records nothing)": (
        lambda q, k, v: A.mha_einsum(q, k, v),
        lambda q, k, v: JA.mha_einsum(q, k, v),
        SPLIT, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_flops_match_jax(case):
    port_fn, jax_fn, shapes, grad = CASES[case]
    want = _jax(jax_fn, *shapes, grad=grad)
    assert _port(port_fn, *shapes, grad=grad) == want
    assert (want == 0.0) == case.startswith("mha_einsum")


def test_backward_flops_split_into_dq_and_dkv():
    """The 5-product backward's 10 B Lq Lk C: 4 recorded by dq, 6 by
    dk/dv; the recorder nests and stops at its ``with``."""
    shapes = PACKED
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*s, generator=gen, requires_grad=True)
               for s in shapes)
    with A.recorded_kernel_flops() as outer:
        with A.recorded_kernel_flops() as inner:
            A.PackedAttention.apply(q, k, v, HEADS, S).sum().backward()
        A.packed_attention_fwd(q.detach(), k.detach(), v.detach(), HEADS)
    unit = b * LQ * LK * C
    assert inner.by_wrapper == {"packed_attention_lse_fwd": 4.0 * unit,
                                "packed_attention_bwd_dq": 4.0 * unit,
                                "packed_attention_bwd_dkv": 6.0 * unit}
    assert outer.total == inner.total + 4.0 * unit
    A.packed_attention_fwd(q.detach(), k.detach(), v.detach(), HEADS)
    assert outer.total == 18.0 * unit


def _tiny_generation_flops(extra=()):
    """(recorded, derived) kernel FLOPs per wrapper of one tiny generation
    under the overrides ``extra``."""
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.train_state import named_roots

    cfg = tp.port_config(tp.TINY_OVERRIDES + list(extra))
    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=1, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], cfg, HashTokenizer(), is_train=False,
                       rng=np.random.default_rng(0))
    models = build_models(cfg, tiny=True, device="cpu")
    for _, m in named_roots(models):
        randomize_weights(m, 0)
    pipe = BEVControlNetPipeline(cfg, models, device="cpu")
    with A.recorded_kernel_flops() as rec:
        pipe(batch, generator=torch.Generator().manual_seed(0))
    unet = models["unet"]
    want = chip_smoke.generate_kernel_flops(
        len(unet.down_blocks[0].resnets), len(models["controlnets"]),
        int(cfg.runner.pipeline_param.num_inference_steps),
        chip_smoke.model_levels(unet, (h // 8, w // 8)),
        unet.block_out_channels, 2 * 1 * 6,
        attn4=chip_smoke.attn4_form(unet),
        cn_cache=int(cfg.runner.pipeline_param.cn_cache_interval))
    return rec, want


def test_tiny_generation_records_the_derived_flops():
    """One tiny generation (B = 1, 3 steps, batched CFG: 12 rows) records,
    per wrapper, ``chip_smoke.generate_kernel_flops``: the launch
    derivation's calls times their per-launch FLOPs."""
    rec, want = _tiny_generation_flops()
    assert rec.by_wrapper == {k: float(v) for k, v in want.items() if v}
    assert rec.total == sum(want.values()) > 0


@pytest.mark.parametrize("extra", [
    ("runner.pipeline_param.cn_cache_interval=2",),
    ("model.unet.neighboring_attn_type=self",),
    ("model.unet.neighboring_attn_type=concat",),
    tuple(f"dataset.neighboring_view_pair.{i}=[{(i - 2) % 6}, {(i + 2) % 6}]"
          for i in range(6))], ids=["cache 2", "self", "concat",
                                    "add over other pairs"])
def test_tiny_generation_options_record_the_derived_flops(extra):
    """As above with the ControlNets at ``ceil(steps / k)`` evaluations
    under the cache, and with each attn4 form's calls (``self`` on 2 rows
    of 6 x 512 and 6 x 128 tokens, ``add`` over other pairs on 24 stacked
    rows)."""
    rec, want = _tiny_generation_flops(extra)
    assert rec.by_wrapper == {k: float(v) for k, v in want.items() if v}
    assert rec.total == sum(want.values()) > 0


def test_count_flops_counts_aten_and_kernel_flops():
    """A conv and a linear: the hand count, 2 FLOPs a multiply-add; a
    kernel wrapper's call lands in the kernel count."""
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    lin = torch.nn.Linear(8 * 16 * 16, 10)
    x = torch.randn(2, 3, 16, 16)
    model, kernel = F.count_flops(lambda t: lin(conv(t).flatten(1)), x)
    assert model == 2 * (2 * 8 * 16 * 16 * 3 * 9) + 2 * (2 * 2048 * 10)
    assert kernel == 0.0
    q = torch.randn(*PACKED[0])
    _, kernel = F.count_flops(A.packed_attention_fwd, q, q[:, :LK], q[:, :LK],
                              HEADS)
    assert kernel == 4.0 * b * LQ * LK * C


def test_device_peak_flops_names(monkeypatch):
    assert F.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu"):
        assert F.device_peak_flops(name) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert F.device_peak_flops() is None and F.mfu(1e15, 1.0) is None
    assert F.mfu(989e12 / 2, 1.0, "NVIDIA H100 80GB HBM3") == 0.5
    assert F.mfu(None, 1.0, "NVIDIA H100 80GB HBM3") is None


def test_numerics_pin_trips_on_perturbation(tmp_path):
    """``tests/test_ops.py::test_numerics_pin_trips_on_perturbation`` on
    the port's pin: matching statistics pass, rounding-sized drift passes,
    a kernel-regression-sized change trips, an unknown key is
    unpinned."""
    pin_file = str(tmp_path / "pins.json")
    arr = torch.linspace(0.0, 1.0, 4096).reshape(1, 64, 64)
    stats = output_stats(arr)
    key = "cuda/gen"
    assert check_pin(stats, key, pin_file=pin_file)["status"] == "unpinned"
    save_pin(stats, key, pin_file=pin_file)
    assert check_pin(stats, key, pin_file=pin_file)["status"] == "ok"
    wiggle = dict(stats, mean=stats["mean"] + 1e-4)
    assert check_pin(wiggle, key, pin_file=pin_file)["status"] == "ok"
    res = check_pin(output_stats(arr * 1.25 + 0.1), key, pin_file=pin_file)
    assert res["status"] == "drift" and "mean" in res["drift"]
    assert json.load(open(pin_file))[key]["max"] == 1.0


def test_committed_pin_holds_the_bench_key():
    """``utils/bench_pins.json`` holds the card's pin for the bench's
    default point and for it with the ControlNet cache every 2 steps
    (``BENCH_CN_CACHE=2``), four finite statistics of images in [0, 1]."""
    pins = json.load(open(bench.__file__.replace(
        "bench.py", "utils/bench_pins.json")))
    key = f"cuda/gen_224x400_b{bench.B}_boxes{bench.MAX_BOXES}"
    for pin in (pins[key], pins[key + "_cn2"]):
        assert set(pin) == {"mean", "std", "min", "max"}
        assert all(math.isfinite(v) for v in pin.values())
        assert 0.0 <= pin["min"] < pin["mean"] < pin["max"] <= 1.0


def test_bench_overlay_maps_to_configs_and_refuses_the_rest(monkeypatch):
    from dualdiff_tpu_torch.utils.config import load_config

    sizes = {"+exp=dual_branch_augloss_fusion": [224, 400],
             "+exp-hd=256x704": [256, 704], "+exp-hd=432x768": [432, 768]}
    for overlay, hw in sizes.items():
        cfg = load_config(bench.config_name(overlay))
        assert cfg.dataset.image_size == hw
        assert cfg.use_dual_controlnet and cfg.use_aug_loss
    with pytest.raises(ValueError, match="BENCH_OVERLAY"):
        bench.config_name("+exp=video_16f")  # clips: BENCH_VIDEO_EXP
    # BENCH_CN_CACHE above 1 turns the ControlNet cache on, with a pin key
    # of its own; 0 and 1 leave the operating point as it is
    name = bench.config_name("+exp=dual_branch_augloss_fusion")
    plain = f"cuda/gen_224x400_b{bench.B}_boxes{bench.MAX_BOXES}"
    for k, want, key in (("0", 0, plain), ("1", 0, plain),
                         ("2", 2, plain + "_cn2"), ("3", 3, plain + "_cn3")):
        monkeypatch.setenv("BENCH_CN_CACHE", k)
        cfg = bench.gen_config(name)
        assert cfg.runner.pipeline_param.cn_cache_interval == want
        assert cfg.runner.pipeline_param.num_inference_steps == bench.STEPS
        assert bench.gen_pin_key(cfg, name) == key
    cfg = bench.gen_config(bench.config_name("+exp=224x400"))
    assert bench.gen_pin_key(cfg, "baseline_224x400") == \
        plain + "_224x400_cn3"
    monkeypatch.setattr(bench, "_device", lambda: {})
    monkeypatch.setenv("BENCH_VIDEO_EXP", "occ_bg")
    with pytest.raises(ValueError, match="BENCH_VIDEO_EXP"):
        bench.main_video_train()


@pytest.mark.parametrize("overlay", sorted(VARIANTS))
def test_bench_takes_every_shipped_image_exp(overlay):
    """``BENCH_OVERLAY`` takes every other shipped image exp, as
    ``bench.py`` takes any overlay: each resolves to its composed config
    (its task is the overlay's exp), and only the flagship's configs keep
    the flagship's metric text and pin keys."""
    name = bench.config_name(overlay)
    assert name == VARIANTS[overlay]
    cfg = load_config(name)
    assert str(cfg.task_id) == overlay.split("=", 1)[1]
    assert name not in bench.FLAGSHIP_CONFIGS
    assert bench._branches(cfg, name).startswith(f"{cfg.task_id}, ")


def test_bench_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_MODE", "gen")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main()
    monkeypatch.setenv("BENCH_MODE", "generate")
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.main()


# bench.py's orchestrate summarises these detail keys
JAX_KEYS = {"train": ("step_time_s", "train_batch_size", "mfu",
                      "mfu_corrected", "section_wall_s"),
            "video": ("sec_per_clip", "frames_per_s", "mfu",
                      "section_wall_s")}


def test_section_merge_builds_the_bench_line(monkeypatch, capsys):
    """The merged line is ``bench.py``'s: the gen section with each other
    section summarised into its detail (``_summarize``), a failed gen a
    placeholder; any failure makes ``orchestrate`` exit 1."""
    gen = {"metric": "m", "value": 0.9, "unit": "frames/s/chip",
           "vs_baseline": 1.8, "detail": {"mfu": 0.1}}
    train = {"value": 30.0, "unit": "images/s/chip", "detail": {
        "step_time_s": 0.4, "train_batch_size": 2, "mfu": 0.2,
        "mfu_corrected": 0.25, "cache_mb": 10.75, "loss": 0.5,
        "section_wall_s": 60.0}}
    video = {"value": 0.07, "unit": "clips/s/chip", "detail": {
        "sec_per_clip": 14.0, "frames_per_s": 1.1, "mfu": 0.3,
        "section_wall_s": 90.0}}
    vtrain = {"error": "exit code 1: out of memory"}
    line = bench.merge(json.loads(json.dumps(gen)), {
        "train": train, "video_16f": video, "video_train": vtrain})
    for key, sec in (("train", train), ("video", video)):
        want = jax_bench._summarize(sec, JAX_KEYS[key])
        assert {k: line["detail"][key][k] for k in want} == want
    assert line["detail"]["train"]["cache_mb"] == 10.75
    assert "loss" not in line["detail"]["train"]
    assert line["detail"]["video_train"] == vtrain
    assert line["value"] == 0.9 and line["detail"]["mfu"] == 0.1
    assert bench.failed(line)
    assert not bench.failed(bench.merge(dict(gen), {"train": train}))
    placeholder = bench.merge({"error": "boom"}, {})
    assert placeholder["value"] is None
    assert placeholder["detail"] == {"error": "boom"}
    assert bench.failed(placeholder)

    runs = {"gen": gen, "train": train, "video_16f": video,
            "video_train": vtrain}
    monkeypatch.setattr(bench, "run_section",
                        lambda mode, timeout: json.loads(json.dumps(
                            runs[mode])))
    assert bench.orchestrate() == 1
    assert json.loads(capsys.readouterr().out)["detail"]["video_train"] \
        == vtrain
    monkeypatch.setenv("BENCH_SKIP_VIDEO", "1")
    assert bench.orchestrate() == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["detail"]) == {"mfu", "train"}
