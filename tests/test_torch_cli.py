"""The port's task CLI against the JAX package's, on the CPU.

- ``Config``, ``_parse_overrides`` and the presets against the JAX ones.
- The CLI builds what the JAX CLI builds: with the trainer and model
  constructors of both packages replaced by recorders (a model's returns
  a stand-in, a trainer's raises after capturing), each task's synthetic
  argv, and each feature-file task's real-data argv with its preset and
  tiny files, pass the same arguments (leaving aside ``use_mesh``,
  ``impl`` and ``device``). Nothing trains there.
- ``--device cpu`` runs each synthetic task (the seven, the MIR and
  classification modes, and highlight detection) and prints the lines the
  JAX CLI prints, in the forms ``bench.py``'s trajectories read.
- The raw-video modes (recognition, egocentric pretraining, MIR and
  classification) run on ``.npy`` clips on the CPU, and build and feed
  their trainers what the JAX CLI does, batch for batch.
- ``--ckpt`` resumes; a SIGTERM ends the run after the epoch in flight
  with its checkpoint on disk.
"""

import contextlib
import importlib
import io
import json
import math
import os
import re
import signal
import sys

import numpy as np
import pytest
import torch

from video_mamba_suite_torch import cli
from video_mamba_suite_torch import configs as port_configs
from video_mamba_suite_torch.utils import Config, latest_step, load_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them faster
    and keeps the test workers beside this file from being
    oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_without_most_optimizations():
    """The JAX CLI builds its datasets here and compiles nothing; should a
    JAX function compile, it does so without most of XLA's optimization
    passes, as in every port test file."""
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _jax():
    from video_mamba_suite_tpu import cli as jax_cli
    from video_mamba_suite_tpu.configs import PRESETS
    from video_mamba_suite_tpu.utils.config import Config as JaxConfig

    return jax_cli, PRESETS, JaxConfig


OVERRIDES = [
    (None, []),
    (None, ["train.mode=mir", "opt.learning_rate=1e-3"]),
    ("tal_thumos", ["dataset.json_file=a/b.json", "model.embd_dim=16",
                    "model.backbone_arch=[1,1,2]",
                    'model.regression_range=[[0,8],[8,32],[32,10000]]']),
    ("vtg_qvhighlights", ['dataset.v_feat_dirs=["x", "y"]',
                          "dataset.max_v_l=16", "loader.batch_size=2",
                          "model.mamba_type=vim"]),
    ("dvc_yc2_tsn", ["model.num_queries=4", "dataset.rerank=true",
                     "new.section.value=null"]),
    ("tas_gtea", ["model.mixer=dbm", "loader.sample_rate=2",
                  'dataset.extra={"a": [1, {"b": 2}]}']),
    ("ego_ek100_cls", ["aug.mixup=0.0", "model.depth=1",
                       "dataset.csv_path=c.csv"]),
    ("anticipation_ek100", ["model.d_model=16", "dataset.sessions=[\"s\"]",
                            "text=not json"]),
]


@pytest.mark.parametrize("preset,pairs", OVERRIDES,
                         ids=[f"{p}-{len(a)}" for p, a in OVERRIDES])
def test_config_and_overrides_match_jax(preset, pairs):
    jax_cli, presets, JaxConfig = _jax()
    want = JaxConfig(presets[preset]) if preset else JaxConfig()
    want = want.override(jax_cli._parse_overrides(pairs))
    got = (Config(port_configs.PRESETS[preset]) if preset else Config())
    got = got.override(cli._parse_overrides(pairs))
    assert got.to_dict() == want.to_dict()
    assert got.dumps() == want.dumps()
    merged = got.merged({"opt": {"extra": 1}, "train": {"mode": "cls"}})
    assert merged.to_dict() == want.merged(
        {"opt": {"extra": 1}, "train": {"mode": "cls"}}).to_dict()
    if got.get("opt"):
        assert got.opt == got["opt"]


@pytest.mark.parametrize("family", ["tal", "tas", "vtg", "dvc",
                                    "anticipation", "ego", "recognition"])
def test_presets_equal_jax(family):
    """Every name of the JAX ``PRESETS`` (as Python resolves the dict: its
    later ``"dvc_yc2_tsn"`` wins) is the port's, with an equal entry."""
    _, presets, _ = _jax()
    assert set(port_configs.PRESETS) == set(presets)
    names = [n for n in presets if n.split("_")[0] == family]
    assert names
    for name in names:
        assert port_configs.PRESETS[name] == presets[name], name


def test_preset_constants_equal_their_entries():
    c, p = port_configs, port_configs.PRESETS
    for const, name in ((c.TAS_GTEA, "tas_gtea"),
                        (c.TAS_50SALADS, "tas_50salads"),
                        (c.TAS_BREAKFAST, "tas_breakfast"),
                        (c.VTG_QVHIGHLIGHTS, "vtg_qvhighlights"),
                        (c.VTG_CHARADES, "vtg_charades"),
                        (c.VTG_TACOS, "vtg_tacos"),
                        (c.VTG_EGO4D, "vtg_ego4d"),
                        (c.VTG_TVSUM, "vtg_tvsum"),
                        (c.DVC_ANET_C3D, "dvc_anet_c3d"),
                        (c.DVC_YC2_TSN, "dvc_yc2_tsn")):
        assert const == p[name]
    for const, name in ((c.TAL_THUMOS, "tal_thumos"),
                        (c.TAL_ANET, "tal_anet")):
        dataset = dict(const["dataset"])
        assert dataset.pop("train_videos") > 0
        assert dict(const, dataset=dataset, train_cfg=None) == \
            dict(p[name], train_cfg=None)


def test_load_config_reads_json_and_yaml(tmp_path, monkeypatch):
    (tmp_path / "c.json").write_text(json.dumps(
        {"opt": {"learning_rate": 0.5}, "model": {"depth": 2}}))
    cfg = load_config(str(tmp_path / "c.json"),
                      defaults=port_configs.PRESETS["tas_gtea"])
    assert cfg.opt.learning_rate == 0.5 and cfg.opt.epochs == 120
    assert cfg.model.depth == 2 and cfg.model.num_layers == 10
    (tmp_path / "c.yaml").write_text("opt:\n  learning_rate: 0.25\n")
    assert load_config(str(tmp_path / "c.yaml")).opt.learning_rate == 0.25
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_config(str(tmp_path / "c.yaml"))
    assert load_config(str(tmp_path / "c.json")).model.depth == 2


# --- the CLI builds what the JAX CLI builds -------------------------------

MODELS = [("tasks.captioning", "PDVC"), ("tasks.anticipation", "LSTRMamba"),
          ("models.vivim", "ViViM"), ("models.clip", "CLIP")]
TRAINERS = [("tasks.tas", "TasTrainer"), ("tasks.tal", "TalTrainer"),
            ("tasks.vtg", "VtgTrainer"), ("tasks.vtg.hl", "HlTrainer"),
            ("tasks.captioning", "CaptioningTrainer"),
            ("tasks.anticipation", "AnticipationTrainer"),
            ("tasks.recognition", "RecognitionTrainer"),
            ("tasks.egocentric", "ClipPretrainer"),
            ("tasks.egocentric.finetune", "MirFinetuner"),
            ("tasks.egocentric.finetune", "ClsFinetuner")]
LEFT_ASIDE = ("use_mesh", "impl", "device")
# the constructors that build modules, and so take the device
BUILDS_A_MODEL = {name for _, name in MODELS} | {
    "TasTrainer", "TalTrainer", "VtgTrainer", "HlTrainer"}


class _Built:
    """A model constructor's call: equal where the arguments are."""

    def __init__(self, name, args, kwargs):
        self.call = (name, args, {k: v for k, v in kwargs.items()
                                  if k not in LEFT_ASIDE})

    def __eq__(self, other):
        return isinstance(other, _Built) and self.call == other.call

    def __repr__(self):
        return f"_Built{self.call}"


class _Stop(Exception):
    pass


def record_constructors(monkeypatch, package):
    """Replace the constructors the CLI of ``package`` calls; returns the
    list the calls go to, as (name, positional arguments, keyword
    arguments)."""
    calls = []

    def recorder(name, trainer):
        def build(*args, **kwargs):
            calls.append((name, args, kwargs))
            if trainer:
                raise _Stop(name)
            return _Built(name, args, kwargs)
        return build

    for table, trainer in ((MODELS, False), (TRAINERS, True)):
        for module, name in table:
            mod = importlib.import_module(f"{package}.{module}")
            monkeypatch.setattr(mod, name, recorder(name, trainer))
    return calls


def _aside(calls):
    return [(name, args, {k: v for k, v in kwargs.items()
                          if k not in LEFT_ASIDE})
            for name, args, kwargs in calls]


def _write_tas(root):
    feat_dir, gt_dir = root / "features", root / "groundTruth"
    feat_dir.mkdir()
    gt_dir.mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i in range(3):
        names.append(f"vid{i}.txt")
        np.save(feat_dir / f"vid{i}.npy",
                rng.standard_normal((8, 24)).astype(np.float32))
        (gt_dir / names[-1]).write_text("\n".join(["walk"] * 12
                                                  + ["run"] * 12) + "\n")
    (root / "mapping.txt").write_text("0 walk\n1 run\n")
    (root / "train.txt").write_text("\n".join(names) + "\n")
    (root / "test.txt").write_text(names[0] + "\n")
    return ["--preset", "tas_gtea", "--set",
            f"dataset.features_path={feat_dir}", f"dataset.gt_path={gt_dir}",
            f"dataset.vid_list={root}/train.txt",
            f"dataset.mapping_file={root}/mapping.txt",
            f"dataset.test_vid_list={root}/test.txt"]


def _write_tal(root):
    feat_dir = root / "feats"
    feat_dir.mkdir()
    rng = np.random.default_rng(1)
    db = {}
    for i in range(3):
        vid = f"video_{i}"
        np.save(feat_dir / f"{vid}.npy",
                rng.standard_normal((8, 64)).astype(np.float32))
        db[vid] = dict(subset="training" if i < 2 else "test",
                       duration=64.0, fps=1.0,
                       annotations=[dict(segment=[8.0, 24.0], label_id=0)])
    (root / "anno.json").write_text(json.dumps({"database": db}))
    return ["--preset", "tal_thumos", "--set",
            f"dataset.json_file={root}/anno.json",
            f"dataset.feat_folder={feat_dir}", 'dataset.val_split=["test"]']


def _write_vtg(root):
    vdir, qdir = root / "vid_feats", root / "q_feats"
    vdir.mkdir()
    qdir.mkdir()
    rng = np.random.default_rng(2)
    lines = []
    for i in range(4):
        np.save(vdir / f"v{i}.npy",
                rng.standard_normal((16, 8)).astype(np.float32))
        np.save(qdir / f"{100 + i}.npy",
                rng.standard_normal((4, 8)).astype(np.float32))
        lines.append(json.dumps(dict(qid=100 + i, vid=f"v{i}", duration=32.0,
                                     relevant_windows=[[4.0, 16.0]])))
    (root / "train.jsonl").write_text("\n".join(lines) + "\n")
    return ["--preset", "vtg_qvhighlights", "--set",
            f"dataset.train_jsonl={root}/train.jsonl",
            f"dataset.eval_jsonl={root}/train.jsonl",
            f'dataset.v_feat_dirs=["{vdir}"]', f"dataset.q_feat_dir={qdir}"]


def _write_hl(root):
    from video_mamba_suite_torch.tasks.vtg import TVSUM_SPLITS

    rng = np.random.default_rng(3)
    split = TVSUM_SPLITS["BK"]
    for vid in split["train"] + split["val"]:
        np.savez(root / f"{vid}.npz",
                 feat=rng.standard_normal((20, 8)).astype(np.float32),
                 anno=rng.integers(1, 6, (20, 4)).astype(np.float32))
    return ["--preset", "vtg_tvsum", "--set", f"dataset.label_dir={root}"]


def _write_captioning(root):
    feat_dir = root / "c3d"
    feat_dir.mkdir()
    rng = np.random.default_rng(4)
    db = {}
    for i in range(2):
        np.save(feat_dir / f"v_{i}.npy",
                rng.standard_normal((32, 8)).astype(np.float32))
        db[f"v_{i}"] = dict(duration=64.0,
                            timestamps=[[8.0, 24.0], [30.0, 50.0]],
                            sentences=["a person walks",
                                       "a person runs away"])
    (root / "captions.json").write_text(json.dumps(db))
    return ["--preset", "dvc_anet_c3d", "--set",
            f"dataset.annotation_json={root}/captions.json",
            f"dataset.feature_dir={feat_dir}", "dataset.max_seq_len=32"]


def _write_anticipation(root):
    vis_dir, tgt_dir = root / "rgb", root / "target"
    vis_dir.mkdir()
    tgt_dir.mkdir()
    rng = np.random.default_rng(5)
    for s in ("sess0", "sess1"):
        np.save(vis_dir / f"{s}.npy",
                rng.standard_normal((560, 8)).astype(np.float32))
        np.save(tgt_dir / f"{s}.npy", rng.integers(0, 3, 560))
    return ["--preset", "anticipation_ek100", "--set",
            f"dataset.visual_dir={vis_dir}", f"dataset.target_dir={tgt_dir}",
            'dataset.sessions=["sess0", "sess1"]']


SYNTHETIC = [("tas", []), ("tal", []), ("vtg", []),
             ("vtg", ["--set", "dataset.highlight=true"]),
             ("captioning", []), ("anticipation", []), ("recognition", []),
             ("egocentric", []), ("egocentric", ["--set", "train.mode=mir"]),
             ("egocentric", ["--set", "train.mode=cls"])]
REAL = [("tas", _write_tas), ("tal", _write_tal), ("vtg", _write_vtg),
        ("vtg", _write_hl), ("captioning", _write_captioning),
        ("anticipation", _write_anticipation)]
BUILD_CASES = (
    [(task, lambda root, extra=extra: ["--synthetic"] + extra)
     for task, extra in SYNTHETIC]
    + REAL)
BUILD_IDS = ([f"synthetic-{t}{'-' + e[-1] if e else ''}"
              for t, e in SYNTHETIC]
             + [f"real-{t}{'-hl' if w is _write_hl else ''}"
                for t, w in REAL])


@pytest.mark.parametrize("task,argv", BUILD_CASES, ids=BUILD_IDS)
def test_cli_builds_what_the_jax_cli_builds(task, argv, tmp_path,
                                            monkeypatch):
    jax_cli, _, _ = _jax()
    args = [task, "--epochs", "3"] + argv(tmp_path)
    with monkeypatch.context() as m:
        want = record_constructors(m, "video_mamba_suite_tpu")
        with pytest.raises(_Stop):
            jax_cli.main(args)
    with monkeypatch.context() as m:
        got = record_constructors(m, "video_mamba_suite_torch")
        with pytest.raises(_Stop):
            cli.main(args + ["--device", "cpu"])
    assert _aside(got) == _aside(want)
    assert len(got) >= 1
    for name, _, kwargs in got:
        if name in BUILDS_A_MODEL:
            assert kwargs["device"] == "cpu", name


# --- the CLI on the CPU -----------------------------------------------------

def run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


NUM = r"(?:np\.float64\()?([0-9.eE+-]+)"
# each synthetic run's argv and the numbers its last lines must give, read
# by bench.py's patterns (bench_cli_trajectories) where it has one
RUNS = [
    (["tas"], [r"'loss': ([0-9.eE+-]+)", r"eval: \{[^}]*'F1@50': " + NUM]),
    (["tal", "--epochs", "2"], [r"'final_loss': ([0-9.eE+-]+)",
                                r"mAP per tIoU: \[.*\], avg ([0-9.]+)"]),
    (["vtg"], [r"'loss_total': ([0-9.eE+-]+)", r"'R1@0.5': ([0-9.eE+-]+)",
               r"'mAP_avg': ([0-9.eE+-]+)"]),
    (["vtg", "--set", "dataset.highlight=true"],
     [r"eval: tvsum mAP@5 = ([0-9.]+)"]),
    (["captioning"], [r"'loss_total': ([0-9.eE+-]+)",
                      r"eval: \{[^}]*'CIDEr': " + NUM,
                      r"eval: \{[^}]*'METEOR': " + NUM]),
    (["anticipation"], [r"loss ([0-9.eE+-]+)",
                        r"eval: \{[^}]*'mean_AP': " + NUM]),
    (["recognition"], [r"loss ([0-9.eE+-]+)", r"eval: \{[^}]*'top1': " + NUM]),
    (["egocentric"], [r"loss ([0-9.]+), retrieval acc ([0-9.]+)"]),
    (["egocentric", "--set", "train.mode=mir"],
     [r"step \d+: loss ([0-9.eE+-]+)",
      r"loss ([0-9.eE+-]+), avg_map [0-9.eE+-]+",
      r"avg_map ([0-9.eE+-]+)", r"avg_ndcg ([0-9.eE+-]+)"]),
    (["egocentric", "--set", "train.mode=cls"],
     [r"loss ([0-9.]+), action top-1 ([0-9.]+)"]),
]


@pytest.mark.parametrize("argv,patterns", RUNS,
                         ids=["-".join(a[:1] + a[-1:]) for a, _ in RUNS])
def test_cli_runs_each_synthetic_task_on_the_cpu(argv, patterns):
    from video_mamba_suite_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    out = run(argv[:1] + ["--synthetic", "--epochs", "1", "--device", "cpu"]
              + argv[1:])
    assert dict(LAUNCHES) == before          # the plain versions ran
    assert "tensor(" not in out
    for pattern in patterns:
        m = re.search(pattern, out)
        assert m, (pattern, out)
        assert all(math.isfinite(float(g)) for g in m.groups()), out


def test_cli_tas_resume_roundtrip(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = run(["tas", "--synthetic", "--epochs", "1", "--ckpt", ckpt,
                 "--device", "cpu"])
    assert "epoch 0:" in first and "[resume]" not in first
    second = run(["tas", "--synthetic", "--epochs", "2", "--ckpt", ckpt,
                  "--device", "cpu"])
    assert "[resume] restored epoch 0" in second
    assert "epoch 0:" not in second  # continued, not restarted
    assert "epoch 1:" in second and "eval:" in second
    assert latest_step(ckpt) == 1


def test_cli_sigterm_checkpoints_the_epoch_in_flight_and_stops(
        tmp_path, monkeypatch):
    """SIGTERM during epoch 0 of 3: the epoch finishes, its checkpoint is
    written, the loop stops and the run evaluates; the rerun resumes
    after epoch 0."""
    from video_mamba_suite_torch.tasks.vtg import VtgTrainer

    train_epoch = VtgTrainer.train_epoch

    def preempted_epoch(self, *args, **kwargs):
        if self._epoch < 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return train_epoch(self, *args, **kwargs)

    ckpt = str(tmp_path / "ckpt")
    argv = ["vtg", "--synthetic", "--epochs", "3", "--ckpt", ckpt,
            "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setattr(VtgTrainer, "train_epoch", preempted_epoch)
        out = run(argv)
    assert "epoch 0:" in out and "epoch 1:" not in out and "eval:" in out
    assert latest_step(ckpt) == 0
    assert signal.getsignal(signal.SIGTERM) is not None
    out = run(argv)
    assert "[resume] restored epoch 0" in out
    assert "epoch 0:" not in out and "epoch 2:" in out
    assert latest_step(ckpt) == 2


# --- the raw-video modes ----------------------------------------------------

def _write_clips(root, prefix, seed):
    """tests/test_cli_real_data.py's four clips: (6, 16, 16, 3) uint8
    ``.npy`` frame arrays from ``seed``."""
    vdir = root / "videos"
    vdir.mkdir()
    rng = np.random.default_rng(seed)
    names = []
    for i in range(4):
        names.append(f"{prefix}{i}.npy")
        np.save(vdir / names[-1],
                rng.integers(0, 255, (6, 16, 16, 3), dtype=np.uint8))
    return vdir, names


def _write_recognition(root):
    vdir, names = _write_clips(root, "clip", 5)
    (root / "train.csv").write_text(
        "\n".join(f"{n} {i % 2}" for i, n in enumerate(names)) + "\n")
    return ["recognition", "--preset", "recognition_k400_vivim_tiny",
            "--set", f"dataset.train_csv={root}/train.csv",
            f"dataset.video_root={vdir}"]


def _write_captions(root, prefix, seed, caption, mode=()):
    vdir, names = _write_clips(root, prefix, seed)
    (root / "meta.json").write_text(json.dumps(
        [dict(video=n, caption=caption.format(i))
         for i, n in enumerate(names)]))
    return ["egocentric"] + list(mode) + [
        "--set", f"dataset.metadata_json={root}/meta.json",
        f"dataset.video_root={vdir}"]


def _write_pretrain(root):
    argv = _write_captions(root, "ego", 6, "person does thing {}")
    return argv[:1] + ["--preset", "ego_timemamba_pretrain"] + argv[1:]


def _write_mir(root):
    return _write_captions(root, "mir", 7, "cut the {} vegetable",
                           ["--preset", "ego_ek100_mir"])


def _write_cls(root):
    vdir, names = _write_clips(root, "cls", 8)
    (root / "train.csv").write_text(
        "\n".join(f"{n} {i % 2}" for i, n in enumerate(names)) + "\n")
    return ["egocentric", "--preset", "ego_ek100_cls", "--set",
            f"dataset.csv_path={root}/train.csv",
            f"dataset.video_root={vdir}"]


EGO_SMALL = ["dataset.context_length=8", "model.num_frames=2",
             "model.depth=1", "model.vision_width=16", "model.embed_dim=8",
             "model.vision_tower=vivim", "model.img_size=16",
             "model.patch_size=8", "model.text_width=16",
             "model.text_heads=2", "model.text_layers=1",
             "loader.batch_size=2"]
# each raw-video mode: its files, tests/test_cli_real_data.py's overrides
# (without the preset) and the lines its end prints
VIDEO_MODES = {
    "recognition": (_write_recognition, [
        "dataset.num_classes=2", "dataset.crop_size=16",
        "model.num_frames=2", "model.depth=1", "model.embed_dim=16",
        "loader.batch_size=2"], ["epoch 0: loss"]),
    "pretrain": (_write_pretrain, EGO_SMALL, ["epoch 0: loss"]),
    "mir": (_write_mir, ["train.mode=mir"] + EGO_SMALL,
            ["epoch 0: loss", "eval: {", "avg_map"]),
    "cls": (_write_cls, [
        "train.mode=cls", "dataset.num_classes=2", "model.num_frames=2",
        "model.depth=1", "model.embed_dim=16", "model.img_size=16",
        "model.patch_size=8", "loader.batch_size=2"],
        ["epoch 0: loss", "eval: {", "action_top1"]),
}


def _small_argv(mode, root):
    writer, small, _ = VIDEO_MODES[mode]
    argv = writer(root)
    del argv[argv.index("--preset"):argv.index("--preset") + 2]
    return argv + small


def _run_video_mode(mode, tmp_path):
    from video_mamba_suite_torch.ops import LAUNCHES

    before = dict(LAUNCHES)
    out = run(_small_argv(mode, tmp_path)
              + ["--epochs", "1", "--device", "cpu"])
    assert dict(LAUNCHES) == before          # the plain versions ran
    for line in VIDEO_MODES[mode][2]:
        assert line in out, (line, out)
    assert "tensor(" not in out
    loss = float(re.search(r"epoch 0: loss ([0-9.eE+-]+)", out).group(1))
    assert math.isfinite(loss)
    return out


def test_cli_recognition_runs_on_video_files_on_the_cpu(tmp_path):
    _run_video_mode("recognition", tmp_path)


def test_cli_egocentric_pretraining_runs_on_video_files_on_the_cpu(
        tmp_path):
    _run_video_mode("pretrain", tmp_path)


def test_cli_egocentric_mir_runs_on_video_files_on_the_cpu(tmp_path):
    out = _run_video_mode("mir", tmp_path)
    m = re.search(r"'avg_map': ([0-9.eE+-]+)", out)
    assert m and 0 <= float(m.group(1)) <= 100


def test_cli_egocentric_cls_runs_on_video_files_on_the_cpu(tmp_path):
    out = _run_video_mode("cls", tmp_path)
    m = re.search(r"'action_top1': ([0-9.eE+-]+)", out)
    assert m and 0 <= float(m.group(1)) <= 100


def _jax_clip_as_the_port_builds_it(name, kwargs):
    """The JAX CLI's CLIP arguments with the port's two stated
    differences on a TimeMamba tower: no ``scan_blocks`` (a JAX compile
    device, not ported) and the spatial attention on K10
    (``attn_flash="row"``, the einsum path's function)."""
    if name == "CLIP" and kwargs.get("vision_tower") == "timemamba":
        vision = dict(kwargs["vision_cfg"])
        assert vision.pop("scan_blocks") is True
        kwargs = dict(kwargs, vision_cfg=dict(vision, attn_flash="row"))
    return kwargs


class _FirstBatch(Exception):
    pass


def record_video_mode(monkeypatch, package, adjust=lambda n, kw: kw):
    """Replace the constructors of ``package``'s CLI: a model's returns a
    stand-in, a trainer's a stand-in whose ``train_step`` records its
    arguments and raises ``_FirstBatch``. Returns the constructor calls
    and the list the batch goes to."""
    calls, batches = [], []

    class Trainer:
        def train_step(self, *args):
            batches.append(args)
            raise _FirstBatch

    def recorder(name, trainer):
        def build(*args, **kwargs):
            kwargs = adjust(name, kwargs)
            calls.append((name, args, kwargs))
            return Trainer() if trainer else _Built(name, args, kwargs)
        return build

    for table, trainer in ((MODELS, False), (TRAINERS, True)):
        for module, name in table:
            mod = importlib.import_module(f"{package}.{module}")
            monkeypatch.setattr(mod, name, recorder(name, trainer))
    return calls, batches


@pytest.mark.parametrize("mode", list(VIDEO_MODES))
@pytest.mark.parametrize("preset", [True, False],
                         ids=["preset", "small"])
def test_video_modes_build_and_feed_what_the_jax_cli_does(
        mode, preset, tmp_path, monkeypatch):
    """Each raw-video mode builds the JAX CLI's model and trainer
    arguments and hands its trainer's ``train_step`` the same first batch
    (clips, labels and token ids exactly): with the preset (its
    RandAugment and erasing for recognition; the batch cut to 2 of the 4
    files) and with tests/test_cli_real_data.py's small overrides."""
    jax_cli, _, _ = _jax()
    if preset:
        argv = VIDEO_MODES[mode][0](tmp_path) + ["loader.batch_size=2"]
    else:
        argv = _small_argv(mode, tmp_path)
    argv += ["--epochs", "1"]
    with monkeypatch.context() as m:
        want, want_batch = record_video_mode(
            m, "video_mamba_suite_tpu", _jax_clip_as_the_port_builds_it)
        with pytest.raises(_FirstBatch):
            jax_cli.main(argv)
    with monkeypatch.context() as m:
        got, got_batch = record_video_mode(m, "video_mamba_suite_torch")
        with pytest.raises(_FirstBatch):
            cli.main(argv + ["--device", "cpu"])
    assert _aside(got) == _aside(want)
    for name, _, kwargs in got:
        if name in BUILDS_A_MODEL:
            assert kwargs["device"] == "cpu", name
    assert len(got_batch) == len(want_batch) == 1
    assert len(got_batch[0]) == len(want_batch[0]) == 2
    for g, w in zip(got_batch[0], want_batch[0]):
        assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    if mode == "recognition" and preset:     # RandAugment and erasing ran
        assert got_batch[0][0].min() < 0 or got_batch[0][0].max() > 1


# each feature-file task's real-data run at tiny widths (the overrides of
# tests/test_cli_real_data.py), without the preset, and a line its end
# prints
SMALL_REAL = {
    _write_tas: (["model.input_dim=8", "model.num_layers=1",
                  "model.num_f_maps=8", "model.num_decoders=1",
                  "model.channel_masking_rate=0.0"], "eval:"),
    _write_tal: (["dataset.num_classes=2", "dataset.max_seq_len=64",
                  "dataset.feat_stride=1", "dataset.num_frames=1",
                  "model.embd_dim=16", "model.backbone_arch=[1,1,2]",
                  "model.regression_range=[[0,8],[8,32],[32,10000]]",
                  "loader.batch_size=2"], "mAP per tIoU"),
    _write_vtg: (["dataset.max_v_l=16", "dataset.max_q_l=4",
                  "model.embed_dim=16", "model.depth=1",
                  "loader.batch_size=2"], "eval:"),
    _write_hl: (["dataset.highlight=true", "model.embed_dim=16",
                 "model.depth=1", "model.max_v_l=32"],
                "eval: tvsum mAP@5"),
    _write_captioning: (["dataset.max_events=4", "dataset.max_caption_len=6",
                         "model.num_queries=4", "model.d_model=16",
                         "model.n_levels=2", "model.num_encoder_layers=1",
                         "model.num_decoder_layers=1",
                         "loader.batch_size=2"], "para eval:"),
    _write_anticipation: (["dataset.num_classes=3",
                           "model.long_memory_num_samples=8",
                           "model.work_memory_num_samples=6",
                           "model.anticipation_num_samples=2",
                           "model.d_model=16", "model.mamba_layers=1",
                           "loader.batch_size=4"], "epoch 0: loss"),
}


@pytest.mark.parametrize("task,writer", REAL, ids=BUILD_IDS[-len(REAL):])
def test_cli_runs_each_feature_file_task_on_the_cpu(task, writer, tmp_path):
    argv = writer(tmp_path)
    del argv[argv.index("--preset"):argv.index("--preset") + 2]
    small, last = SMALL_REAL[writer]
    out = run([task, "--epochs", "1", "--device", "cpu"] + argv + small)
    assert "epoch 0" in out and last in out, out
    assert "tensor(" not in out


def test_cli_mesh_raises():
    with pytest.raises(ValueError, match="queue 1 item 10"):
        cli.main(["tas", "--synthetic", "--device", "cpu", "--set",
                  "train.use_mesh=true"])
