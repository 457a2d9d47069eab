"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, and its entry points never fall back to the CPU on their own."""

import math
import subprocess
import sys
import textwrap

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import video_mamba_suite_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "video_mamba_suite_tpu"))
        assert not bad, bad
        print(len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 10      # every submodule imported


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import (
        ActionMambaDetector,
        MambaDBM,
        MambaVim,
        TimeMamba,
        build_mamba_lm,
        build_tal_trainer,
        build_timemamba_b,
        from_pretrained,
    )
    from video_mamba_suite_torch.configs import MAMBA_130M, TAL_THUMOS
    from video_mamba_suite_torch.models import MambaCausal

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_timemamba_b(depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mamba_lm(dict(MAMBA_130M, n_layer=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_pretrained("a-checkpoint-directory")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaCausal(d_model=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TimeMamba(img_size=32, embed_dim=32, depth=1, num_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaVim(d_model=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaDBM(d_model=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActionMambaDetector(input_dim=8, num_classes=2, embd_dim=16,
                            backbone_arch=(1, 1, 1),
                            regression_range=((0, 4), (4, 100)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tal_trainer(TAL_THUMOS, embd_dim=16, backbone_arch=(1, 1, 1),
                          regression_range=((0, 4), (4, 100)))


def test_vivim_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import ViViM, build_vivim_tiny_k400
    from video_mamba_suite_torch.models import MambaScanNorm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vivim_tiny_k400(depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViViM(img_size=32, patch_size=8, num_frames=2, depth=1,
              embed_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MambaScanNorm(d_model=16)


def test_vivim_cpu_build_has_the_preset_widths():
    """build_vivim_tiny_k400(device="cpu") is ViViM-T for K400 (the JAX
    preset recognition_k400_vivim_tiny) and serves on the CPU through the
    plain versions."""
    from video_mamba_suite_torch import build_vivim_tiny_k400, predict
    from video_mamba_suite_torch.ops import LAUNCHES

    model = build_vivim_tiny_k400(device="cpu", depth=2, img_size=32,
                                  num_frames=2)
    assert (model.embed_dim, model.num_frames, len(model.layers)) == \
        (192, 2, 2)
    assert model.head.weight.shape == (400, 192)
    assert model.layers[1].drop_path == 0.0    # 0.1 · 0 / (depth - 1)
    assert model.layers[0].mixer.fwd.A_log.shape == (384, 16)
    before = dict(LAUNCHES)
    probs = predict(model, torch.randn(1, 2, 32, 32, 3))
    assert probs.shape == (1, 400) and torch.isfinite(probs).all()
    assert dict(LAUNCHES) == before


def test_cpu_build_runs_plain_versions():
    from video_mamba_suite_torch import build_timemamba_b
    from video_mamba_suite_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    model = build_timemamba_b(device="cpu", dtype=None, depth=1,
                              img_size=32, num_frames=4, embed_dim=64,
                              num_heads=2)
    x = torch.randn(1, 4, 32, 32, 3)
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 512) and torch.isfinite(out).all()
    assert dict(LAUNCHES) == before


def test_anticipation_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import LSTRMamba, build_anticipation_trainer
    from video_mamba_suite_torch.configs import ANTICIPATION_EK100_SHORT

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_anticipation_trainer(ANTICIPATION_EK100_SHORT, d_model=16,
                                   mamba_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSTRMamba(visual_dim=8, d_model=16, num_classes=3, mamba_layers=1)


@pytest.mark.parametrize("name", ["ANTICIPATION_EK100",
                                  "ANTICIPATION_EK100_SHORT"])
def test_anticipation_cpu_build_has_the_preset_widths(name):
    """build_anticipation_trainer(config, device="cpu") keeps the preset's
    widths and recipe (the JAX preset anticipation_ek100, long memory cut
    to 28 in the short configuration); the short one trains and serves on
    the CPU through the plain versions, here at depth 1 and batch 1."""
    from video_mamba_suite_torch import configs
    from video_mamba_suite_torch.ops import LAUNCHES
    from video_mamba_suite_torch.tasks.anticipation import (
        build_anticipation_trainer,
        predict,
    )

    config = getattr(configs, name)
    trainer = build_anticipation_trainer(config, device="cpu",
                                         mamba_layers=1, warmup_steps=0)
    model = trainer.model
    cfg = config["model"]
    tokens = (cfg["long_memory_num_samples"]
              + cfg["work_memory_num_samples"]
              + cfg["anticipation_num_samples"])
    assert tokens == (548 if name == "ANTICIPATION_EK100" else 64)
    assert model.classifier.weight.shape == (3807, 1024)
    assert model.head_long.fusion.weight.shape == (1024, 2048)
    assert model.dec_query.shape == (4, 1024)
    assert model.dropout_cls == 0.2 and config["batch_size"] == 16
    assert trainer.schedule(0) == pytest.approx(7e-5)
    assert trainer.optimizer.param_groups[0]["weight_decay"] == 5e-5
    if tokens > 64:
        return
    frames = cfg["long_memory_num_samples"] + cfg["work_memory_num_samples"]
    g = torch.Generator().manual_seed(0)
    visual = torch.randn(1, frames, 1024, generator=g)
    motion = torch.randn(1, frames, 1024, generator=g)
    targets = torch.randint(3807, (1, 36), generator=g)
    before = dict(LAUNCHES)
    loss = trainer.train_step(visual, motion, targets)
    probs = predict(model, visual, motion)
    assert dict(LAUNCHES) == before
    assert math.isfinite(loss) and probs.shape == (1, 36, 3807)
    assert torch.isfinite(probs).all()


def test_clip_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import CLIP, build_clip_mir
    from video_mamba_suite_torch.models import clip_vivim_tiny

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_clip_mir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIP(vision_cfg=dict(img_size=32, embed_dim=32, depth=1,
                             num_heads=2),
             text_cfg=dict(context_length=8, vocab_size=50, width=32,
                           heads=4, layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip_vivim_tiny()


def test_clip_mir_cpu_build_has_the_preset_widths():
    """build_clip_mir(device="cpu") is CLIP-TimeMamba-B at the EK100 MIR
    preset's widths (the JAX preset ego_ek100_mir as its CLI builds it);
    here with the video tower cut to depth 1 and the text tower to 1
    layer, it serves one clip and two captions on the CPU through the
    plain versions, with attn_flash="row" as without."""
    import copy

    from video_mamba_suite_torch import build_clip_mir
    from video_mamba_suite_torch.configs import CLIP_TIMEMAMBA_B_EK100_MIR
    from video_mamba_suite_torch.ops import LAUNCHES

    config = copy.deepcopy(CLIP_TIMEMAMBA_B_EK100_MIR)
    vision, text = config["model"]["vision_cfg"], config["model"]["text_cfg"]
    assert (vision["embed_dim"], vision["depth"], vision["num_heads"],
            vision["num_frames"], vision["img_size"]) == (768, 12, 12, 16, 224)
    assert (text["context_length"], text["vocab_size"], text["width"],
            text["heads"], text["layers"]) == (77, 49408, 512, 8, 12)
    assert config["opt"] == dict(lr=1e-5, weight_decay=0.01)
    vision.update(depth=1, num_frames=2, img_size=32)
    text["layers"] = 1
    g = torch.Generator().manual_seed(0)
    clip = torch.randn(1, 2, 32, 32, 3, generator=g)
    ids = torch.randint(0, 49408, (2, 77), generator=g)
    before = dict(LAUNCHES)
    outs = []
    for attn_flash in (None, "row"):
        model = build_clip_mir(config, device="cpu",
                               attn_flash=attn_flash).model
        assert model.visual.blocks[0].attn.flash == attn_flash
        assert model.visual.blocks[0].attention_style == "frozen-in-time"
        assert model.visual.image_projection.shape == (768, 512)
        assert model.textual.text_projection.shape == (512, 512)
        with torch.no_grad():
            outs.append(model(clip, ids))
    assert dict(LAUNCHES) == before
    for a, b in zip(outs[0], outs[1]):
        assert torch.allclose(a, b, atol=1e-5)
    assert outs[0][0].shape == (1, 512) and outs[0][1].shape == (2, 512)


@pytest.mark.parametrize("name", ["TAL_THUMOS", "TAL_ANET"])
def test_tal_cpu_build_has_the_preset_widths(name):
    """build_tal_trainer(config, device="cpu") keeps the preset's widths
    and recipe (the JAX presets tal_thumos and tal_anet): 3200-d features
    into a DBM pyramid of width 512 and 6 levels, AdamW with weight decay
    0.05 after a warmup of 5 epochs, drop-path 0.1."""
    from video_mamba_suite_torch import build_tal_trainer, configs
    from video_mamba_suite_torch.models import MambaDBM

    config = getattr(configs, name)
    d = config["dataset"]
    trainer = build_tal_trainer(config, device="cpu")
    model = trainer.model
    T = d["max_seq_len"]
    assert (d["input_dim"], T, model.num_classes) == \
        ((3200, 2304, 20) if name == "TAL_THUMOS" else (3200, 192, 1))
    assert model.backbone.embd[0].weight.shape == (512, 3200, 3)
    assert len(model.backbone.stem) == 2 and len(model.backbone.branch) == 5
    mixer = model.backbone.branch[4].mamba
    assert isinstance(mixer, MambaDBM)
    assert mixer.in_proj.weight.shape == (2048, 512)
    assert model.backbone.stem[0].drop_path.rate == 0.1
    assert model.level_lengths(T)[-1] == T // 32
    steps = d["train_videos"] // config["loader"]["batch_size"]
    lr = config["opt"]["learning_rate"]
    assert trainer.schedule(0) == 0.0
    assert trainer.schedule(5 * steps) == pytest.approx(lr)
    assert trainer.optimizer.param_groups[0]["weight_decay"] == 0.05


def test_tas_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import MaTransformer, build_tas_trainer
    from video_mamba_suite_torch.configs import TAS_GTEA

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tas_trainer(TAS_GTEA, num_layers=1, num_decoders=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MaTransformer(num_decoders=1, num_layers=1, num_f_maps=8,
                      input_dim=4, num_classes=3)


@pytest.mark.parametrize("name,classes,sample_rate", [
    ("TAS_GTEA", 11, 1), ("TAS_50SALADS", 19, 2), ("TAS_BREAKFAST", 48, 1)])
def test_tas_cpu_build_has_the_preset_widths(name, classes, sample_rate):
    """build_tas_trainer(config, device="cpu") is ASFormer-Mamba at the
    preset's widths (the JAX presets tas_gtea, tas_50salads,
    tas_breakfast): 2048-d features, 10 encoder layers of masked ViM
    blocks at d_model 64 (d_inner 128), 3 decoders of 10 layers, Adam 5e-4
    with L2 1e-5; the GTEA build trains and predicts a 70-step video on
    the CPU through the plain versions."""
    from video_mamba_suite_torch import build_tas_trainer, configs
    from video_mamba_suite_torch.ops import LAUNCHES

    config = getattr(configs, name)
    assert config["loader"] == dict(batch_size=1, sample_rate=sample_rate)
    trainer = build_tas_trainer(config, device="cpu")
    model = trainer.model
    assert model.encoder.conv_1x1.weight.shape == (64, 2048, 1)
    assert len(model.encoder.layers) == 10 and len(model.decoders) == 3
    assert all(len(d.layers) == 10 for d in model.decoders)
    mixer = model.encoder.layers[9].mamba_block.mamba
    assert mixer.fwd.A_log.shape == (128, 16)
    assert model.encoder.layers[9].feed_forward.dilation == 512
    assert model.decoders[2].conv_out.weight.shape == (classes, 64, 1)
    assert model.decoders[2].layers[0].alpha == pytest.approx(math.exp(-6))
    assert model.encoder.layers[0].mamba_block.drop_path.rate == 0.3
    assert model.encoder.channel_masking_rate == 0.3
    group = trainer.optimizer.param_groups[0]
    assert isinstance(trainer.optimizer, torch.optim.Adam)
    assert (group["lr"], group["weight_decay"]) == (5e-4, 1e-5)
    if name != "TAS_GTEA":
        return
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(1, 70, 2048, generator=g)
    targets = torch.randint(classes, (1, 70), generator=g)
    mask = torch.ones(1, 70)
    before = dict(LAUNCHES)
    loss = trainer.train_step(feats, targets, mask)
    preds, probs = trainer.predict(feats, mask)
    assert dict(LAUNCHES) == before
    assert math.isfinite(loss) and preds.shape == (1, 70)
    assert probs.shape == (1, 70, classes)


def test_vtg_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import (
        QfvsTrainer,
        UniVTGMamba,
        build_hl_trainer,
        build_vtg_trainer,
    )
    from video_mamba_suite_torch.configs import VTG_QVHIGHLIGHTS, VTG_TVSUM
    from video_mamba_suite_torch.tasks.vtg import (
        VlpPretrainer,
        vtg_trainer_kwargs,
    )

    small = dict(embed_dim=16, depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vtg_trainer(VTG_QVHIGHLIGHTS, **small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hl_trainer(VTG_TVSUM, **small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VlpPretrainer(**dict(vtg_trainer_kwargs(VTG_QVHIGHLIGHTS), **small))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QfvsTrainer(txt_dim=4, vid_dim=4, **small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UniVTGMamba(txt_dim=4, vid_dim=4, **small)


@pytest.mark.parametrize("name,vid_dim,max_v_l", [
    ("VTG_QVHIGHLIGHTS", 2816, 75), ("VTG_CHARADES", 4096, 75),
    ("VTG_TACOS", 2816, 128), ("VTG_EGO4D", 2304, 255),
    ("VTG_TVSUM", 2816, 512)])
def test_vtg_cpu_build_has_the_preset_widths(name, vid_dim, max_v_l):
    """build_vtg_trainer(config, device="cpu") (build_hl_trainer for
    TVSum) is UniVTG-Mamba at the preset's widths (the JAX presets
    vtg_qvhighlights, vtg_charades, vtg_tacos, vtg_ego4d, vtg_tvsum): 512-d
    text and the dataset's video features projected to 1024, 6 DBM layers
    (expand 1), input dropout 0.5, drop-path 0.1, queries of 32 tokens,
    AdamW 1e-4 with decay 1e-4 and clip 0.1."""
    from video_mamba_suite_torch import (
        build_hl_trainer,
        build_vtg_trainer,
        configs,
    )
    from video_mamba_suite_torch.models import MambaDBM

    config = getattr(configs, name)
    build = build_hl_trainer if name == "VTG_TVSUM" else build_vtg_trainer
    trainer = build(config, device="cpu")
    model = trainer.model
    assert model.vid_proj[0].dense.weight.shape == (1024, vid_dim)
    assert model.vid_proj[1].dense.weight.shape == (1024, 1024)
    assert model.txt_proj[0].dense.weight.shape == (1024, 512)
    assert model.vid_proj[0].rate == 0.5 and model.drop_path_rate == 0.1
    assert len(model.layers) == 6
    mixer = model.layers[5].mixer
    assert isinstance(mixer, MambaDBM)
    assert mixer.in_proj.weight.shape == (4096, 1024)
    assert mixer.shared.A_log.shape == (1024, 16)
    assert trainer.max_v_l == max_v_l
    if name != "VTG_TVSUM":
        assert trainer.max_q_l == 32
    group = trainer.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (1e-4, 1e-4)
    assert trainer.grad_clip == 0.1
    assert config["loader"]["batch_size"] == (4 if name == "VTG_TVSUM"
                                              else 32)


def test_captioning_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    from video_mamba_suite_torch import PDVC, build_captioning_trainer
    from video_mamba_suite_torch.configs import DVC_ANET_C3D

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_captioning_trainer(DVC_ANET_C3D, 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PDVC(input_dim=8, d_model=16, n_levels=2, num_encoder_layers=1,
             num_decoder_layers=1)


@pytest.mark.parametrize("name,input_dim,queries,events,head", [
    ("DVC_ANET_C3D", 500, 10, 10, "DSACaptioner"),
    ("DVC_YC2_TSN", 3072, 100, 20, "LSTMCaptioner")])
def test_captioning_cpu_build_has_the_preset_widths(name, input_dim, queries,
                                                    events, head):
    """build_captioning_trainer(config, vocab, device="cpu") keeps the
    preset's widths (read as the JAX CLI reads them, its defaults where
    the preset names none): width 512, 4 levels, 2 ViM encoder layers
    (d_inner 1024) and 2 decoder layers, the preset's queries, counts and
    caption head, captions of 30 tokens, AdamW 5e-5 with decay 1e-4,
    batches of 256 features and 10 events."""
    from video_mamba_suite_torch import build_captioning_trainer, configs
    from video_mamba_suite_torch.tasks import captioning

    trainer = build_captioning_trainer(getattr(configs, name), 50,
                                       device="cpu")
    m = trainer.model
    assert type(m.caption_head).__name__ == head
    assert m.input_proj.weight.shape == (512, input_dim)
    assert m.query_embed.shape == (queries, 1024)
    assert m.count_head.weight.shape == (events + 1, 512)
    assert len(m.level_convs) == 3 and m.max_caption_len == 30
    assert len(m.transformer.enc) == 2 and len(m.transformer.dec) == 2
    assert m.transformer.enc[1].mamba.fwd.A_log.shape == (1024, 16)
    assert m.caption_head.logit.weight.shape[0] == 50
    assert captioning.pdvc_level_shapes(trainer.max_seq_len, 4) == \
        (256, 128, 64, 32)
    assert trainer.max_events == 10
    group = trainer.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (5e-5, 1e-4)


def test_cli_and_trainer_core_import_no_jax(tmp_path):
    """The task CLI, the trainer core's modules and the native NMS import
    neither JAX nor the JAX package, also while the CLI runs two tasks
    and checkpoints one."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("cli", "__main__", "utils.config", "utils.checkpoint",
                     "utils.trainer", "utils.preemption", "utils.meters",
                     "utils.logging", "utils.profiling", "tasks.tal.nms"):
            importlib.import_module("video_mamba_suite_torch." + name)
        from video_mamba_suite_torch.cli import main
        main(["anticipation", "--synthetic", "--epochs", "1",
              "--device", "cpu"])
        main(["recognition", "--synthetic", "--epochs", "1",
              "--device", "cpu", "--ckpt", {str(tmp_path)!r}])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "video_mamba_suite_tpu"))
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "eval:" in res.stdout
    assert (tmp_path / "0").is_dir()


@pytest.mark.parametrize("argv", [
    ["tas"], ["tal"], ["vtg"], ["vtg", "--set", "dataset.highlight=true"],
    ["captioning"], ["anticipation"], ["recognition"], ["egocentric"],
    ["egocentric", "--set", "train.mode=mir"],
    ["egocentric", "--set", "train.mode=cls"]],
    ids=lambda a: "-".join(a[:1] + a[-1:]))
def test_cli_builds_on_cuda_by_default(argv, monkeypatch):
    """Without --device, every module the CLI builds is asked for
    "cuda"; without a card the run raises rather than go on on the CPU."""
    import importlib

    from video_mamba_suite_torch import cli

    devices = []

    class Stop(Exception):
        pass

    def recorder(name, stop):
        def build(*args, **kwargs):
            devices.append((name, kwargs.get("device", "absent")))
            if stop:
                raise Stop(name)
            return object()
        return build

    for module, name, stop in [
            ("tasks.tas", "TasTrainer", True), ("tasks.tal", "TalTrainer", True),
            ("tasks.vtg", "VtgTrainer", True),
            ("tasks.vtg.hl", "HlTrainer", True),
            ("tasks.captioning", "PDVC", True),
            ("tasks.anticipation", "LSTRMamba", True),
            ("models.vivim", "ViViM", True), ("models.clip", "CLIP", True)]:
        mod = importlib.import_module(f"video_mamba_suite_torch.{module}")
        monkeypatch.setattr(mod, name, recorder(name, stop))
    args = argv[:1] + ["--synthetic", "--epochs", "2"] + argv[1:]
    with pytest.raises(Stop):
        cli.main(args)
    assert len(devices) == 1 and devices[0][1] == "cuda", devices
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)


def test_data_stack_imports_no_jax(tmp_path):
    """The data layer and the run-on-video pipeline import neither JAX nor
    the JAX package, also while they decode, augment, read features and
    prefetch."""
    code = textwrap.dedent(f"""
        import importlib, sys
        import numpy as np
        for name in ("data", "data.video", "data.video_augment",
                     "data.video_datasets", "data.tokenizer",
                     "data.features", "data.pt_reader", "ops.native",
                     "tasks.vtg.run_on_video"):
            importlib.import_module("video_mamba_suite_torch." + name)
        from video_mamba_suite_torch.data import (
            FeatureReader, PrefetchLoader, VideoDecoder, preprocess_clip)
        from video_mamba_suite_torch.data.video_augment import \\
            make_train_augment
        clip = np.random.default_rng(0).integers(0, 255, (4, 20, 24, 3),
                                                 dtype=np.uint8)
        np.save({str(tmp_path / "v.npy")!r}, clip)
        frames = VideoDecoder({str(tmp_path / "v.npy")!r}).get_batch([0, 3])
        preprocess_clip(frames, size=16, device="cpu")
        make_train_augment(dict(aa="rand-m7-n4-mstd0.5-inc1",
                                reprob=0.25))(frames)
        FeatureReader({str(tmp_path)!r})("v")
        list(PrefetchLoader(lambda i: frames, 2, device="cpu"))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "video_mamba_suite_tpu"))
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_data_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    import numpy as np

    from video_mamba_suite_torch.data import PrefetchLoader, preprocess_clip
    from video_mamba_suite_torch.tasks.vtg import VtgFeatureExtractor

    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(lambda i: i, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_clip(np.zeros((2, 8, 8, 3), np.uint8), size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VtgFeatureExtractor(
            image_cfg=dict(img_size=32, patch_size=16, width=16, layers=1,
                           heads=2, output_dim=8),
            text_cfg=dict(context_length=8, vocab_size=16, width=16,
                          heads=2, layers=1, output_dim=8))
    # the host-only parts need no device
    assert list(PrefetchLoader(lambda i: i, 2, device_put=False)) == [0, 1]


def test_not_ported_parts_name_their_roadmap_item():
    """What waits for the parallel layer says so: the LM's MoE interleave,
    a sharded PrefetchLoader and data-parallel trainers name ROADMAP queue
    1 item 10."""
    from video_mamba_suite_torch.data import PrefetchLoader
    from video_mamba_suite_torch.models.mixer_seq import MixerModel
    from video_mamba_suite_torch.utils.trainer import TrainerCore

    with pytest.raises(NotImplementedError,
                       match=r"MoE interleave .*ROADMAP queue 1 item 10"):
        MixerModel(16, 1, 8, moe_every=2, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        PrefetchLoader(lambda i: i, 2, sharding="data", device="cpu")
    with pytest.raises(ValueError, match="queue 1 item 10"):
        TrainerCore(use_mesh=True)
