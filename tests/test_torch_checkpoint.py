"""The port's checkpoints, trainer core, preemption and training
utilities, on the CPU.

Every trainer with a ``restore`` resumes exactly: two steps in a row
leave the same state (each parameter, the optimizer's state, the EMA, the
loss normaliser, the schedule, the generators, the epoch count) as one
step, ``save``, a fresh trainer's ``restore`` and one step, under
``torch.equal``. The checkpoint files load with ``weights_only=True``.
Widths are tiny; the plain versions run.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

from video_mamba_suite_torch.utils import (
    AverageMeter,
    MetricLogger,
    PreemptionWatcher,
    StepTimer,
    TrainerCore,
    latest_step,
    live_memory_bytes,
    restore_checkpoint,
    save_checkpoint,
    trace,
)
from video_mamba_suite_torch.utils.checkpoint import STATE_FILE


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
    """JAX, where a test here reaches it, compiles without most of XLA's
    optimization passes, as in every port test file."""
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _vivim(num_classes):
    from video_mamba_suite_torch.models.vivim import ViViM

    return ViViM(img_size=16, patch_size=8, num_frames=2, depth=2,
                 embed_dim=16, num_classes=num_classes, device="cpu")


def _clip():
    from video_mamba_suite_torch.models.clip import CLIP

    return CLIP(embed_dim=8, vision_tower="vivim",
                vision_cfg=dict(img_size=16, patch_size=8, num_frames=2,
                                depth=1, embed_dim=16),
                text_cfg=dict(context_length=4, vocab_size=20, width=16,
                              heads=2, layers=1), device="cpu")


def _clip_pairs():
    r = _rng(1)
    return (r.standard_normal((3, 2, 16, 16, 3)).astype(np.float32),
            r.integers(1, 20, (3, 4)))


def recognition():
    from video_mamba_suite_torch.tasks.recognition import RecognitionTrainer

    tr = RecognitionTrainer(_vivim(3), num_classes=3, lr=1e-2,
                            warmup_steps=1, total_steps=10)
    videos = _rng().standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    return tr, lambda t: t.train_step(videos, np.array([0, 2]))


def anticipation():
    from video_mamba_suite_torch.tasks.anticipation import (
        AnticipationTrainer,
        LSTRMamba,
    )

    model = LSTRMamba(visual_dim=8, motion_dim=4, d_model=16, num_classes=3,
                      long_memory_num_samples=4, work_memory_num_samples=4,
                      anticipation_num_samples=2, mamba_layers=1,
                      dropout_cls=0.5, device="cpu")
    tr = AnticipationTrainer(model, lr=1e-2, warmup_steps=1, total_steps=10)
    r = _rng()
    vis = r.standard_normal((2, 8, 8)).astype(np.float32)
    mot = r.standard_normal((2, 8, 4)).astype(np.float32)
    tgt = r.integers(0, 3, (2, 6))
    return tr, lambda t: t.train_step(vis, mot, tgt)


def tal():
    from video_mamba_suite_torch.tasks.tal import (
        TalTrainer,
        make_synthetic_tal,
    )

    tr = TalTrainer(input_dim=8, num_classes=2, max_seq_len=32, embd_dim=16,
                    backbone_arch=(1, 1, 1),
                    regression_range=[(0, 4), (4, 100)], lr=1e-2,
                    warmup_steps=1, total_steps=10, device="cpu")
    items = make_synthetic_tal(num_videos=3, num_classes=2, feat_dim=8,
                               seq_len=32)
    return tr, lambda t: t.train_epoch(items, batch_size=2)


def tas():
    from video_mamba_suite_torch.tasks.tas import (
        TasTrainer,
        collate,
        make_synthetic_dataset,
    )

    tr = TasTrainer(num_classes=3, input_dim=8, num_layers=1, num_f_maps=8,
                    num_decoders=1, device="cpu")
    data = make_synthetic_dataset(num_videos=2, num_classes=3, feat_dim=8,
                                  min_len=20, max_len=30)

    class Gen:
        i = 0

        def has_next(self):
            return self.i < len(data)

        def next_batch(self, bs, if_warp=False):
            chunk = data[self.i:self.i + bs]
            self.i += bs
            return collate(chunk, pad_to=16) + ([""] * len(chunk),)

        def reset(self):
            self.i = 0

    return tr, lambda t: t.train_epoch(Gen(), batch_size=1)


def vtg():
    from video_mamba_suite_torch.tasks.vtg import (
        VtgTrainer,
        make_synthetic_vtg,
    )

    tr = VtgTrainer(txt_dim=8, vid_dim=8, embed_dim=16, depth=1, max_q_l=4,
                    max_v_l=16, device="cpu")
    samples = make_synthetic_vtg(num_samples=4, ctx_l=16, txt_len=4,
                                 txt_dim=8, vid_dim=8)
    return tr, lambda t: t.train_epoch(samples, batch_size=2)


def _hl_samples(n):
    r = _rng(2)
    return [dict(vid_feat=r.standard_normal((16, 8)).astype(np.float32),
                 saliency=(r.random(16) > 0.5).astype(np.float32))
            for _ in range(n)]


def hl():
    from video_mamba_suite_torch.tasks.vtg import HlTrainer

    tr = HlTrainer(txt_dim=8, vid_dim=8, embed_dim=16, depth=1, max_v_l=16,
                   device="cpu")
    samples = _hl_samples(4)
    return tr, lambda t: t.train_epoch(samples, batch_size=2)


def captioning():
    from video_mamba_suite_torch.tasks.captioning import (
        PDVC,
        CaptioningTrainer,
    )

    model = PDVC(input_dim=6, num_classes=1, vocab_size=8, num_queries=3,
                 d_model=16, n_levels=2, num_encoder_layers=1,
                 num_decoder_layers=1, max_caption_len=4, device="cpu")
    tr = CaptioningTrainer(model, lr=1e-3)
    B, T = 2, 16
    feats = _rng().standard_normal((B, T, 6)).astype(np.float32)
    boxes = np.array([[[0.3, 0.2], [0.0, 0.0]],
                      [[0.6, 0.3], [0.0, 0.0]]], np.float32)
    valid = np.array([[True, False], [True, False]])
    caps = np.full((B, 2, 5), -100, np.int64)
    caps[:, 0] = [0, 3, 4, 5, 0]
    batch = (feats, np.ones((B, T), np.float32), boxes,
             np.zeros((B, 2), np.int64), valid, caps)
    return tr, lambda t: t.train_step(*batch)


def pretrain():
    from video_mamba_suite_torch.tasks.egocentric import ClipPretrainer

    tr = ClipPretrainer(_clip(), lr=1e-3, warmup_steps=1, total_steps=10)
    videos, texts = _clip_pairs()
    return tr, lambda t: t.train_step(videos, texts)


def mir():
    from video_mamba_suite_torch.tasks.egocentric import MirFinetuner

    tr = MirFinetuner(_clip(), lr=1e-3, warmup_steps=1, total_steps=10)
    videos, texts = _clip_pairs()
    return tr, lambda t: t.train_step(videos, texts)


def cls():
    from video_mamba_suite_torch.tasks.egocentric import ClsFinetuner

    tr = ClsFinetuner(_vivim(0), num_classes=3, lr=1e-2, warmup_steps=1,
                      total_steps=10, mixup_alpha=0.8, cutmix_alpha=1.0)
    videos = _rng().standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    return tr, lambda t: t.train_step(videos, np.array([1, 2]))


TRAINERS = [recognition, anticipation, tal, tas, vtg, hl, captioning,
            pretrain, mir, cls]


def all_steps(directory):
    """The step directories that hold a state file."""
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit()
                  and os.path.isfile(os.path.join(directory, n, STATE_FILE)))


def assert_same_state(got, want, path="state"):
    """``got`` equals ``want`` leaf by leaf: tensors under
    ``torch.equal`` (dtype and shape included), everything else under
    ``==``."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got.cpu(), want.cpu()), path
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_same_state(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_state(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("make", TRAINERS, ids=[f.__name__ for f in TRAINERS])
def test_resume_equals_the_uninterrupted_run(make, tmp_path):
    d = str(tmp_path / "ckpt")
    straight, step = make()
    step(straight)
    step(straight)

    first, step = make()
    step(first)
    first.save(d, 0)
    resumed, step = make()
    assert resumed.restore(str(tmp_path / "empty")) is None
    assert resumed.restore(d) == 0
    step(resumed)
    state = resumed.state_dict()
    assert any(isinstance(v, torch.Tensor) and v.dtype == torch.uint8
               for v in state.values()), "no generator state is saved"
    assert_same_state(state, straight.state_dict())
    # the file holds what the trainer held at the save
    assert_same_state(restore_checkpoint(d, 0), first.state_dict())


def test_qfvs_trainer_saves_its_state(tmp_path):
    """QfvsTrainer saves and has no restore, as the JAX trainer; its
    checkpoint reads back equal."""
    from video_mamba_suite_torch.tasks.vtg import (
        QfvsTrainer,
        collate_qfvs,
        make_synthetic_qfvs,
    )

    items, _ = make_synthetic_qfvs(num_items=2, n_segments=2, n_frames=4,
                                   vid_dim=8, txt_dim=8)
    tr = QfvsTrainer(txt_dim=8, vid_dim=8, embed_dim=16, depth=1,
                     device="cpu")
    tr.train_step(*collate_qfvs(items))
    d = str(tmp_path / "ckpt")
    tr.save(d, 3)
    assert not hasattr(tr, "restore")
    assert latest_step(d) == 3
    assert_same_state(restore_checkpoint(d), tr.state_dict())


def test_checkpoint_steps_and_max_to_keep(tmp_path):
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None and restore_checkpoint(d) is None
    for step in (4, 1, 7, 9, 12):
        save_checkpoint(d, step, {"w": torch.full((2,), float(step))})
    assert all_steps(d) == [7, 9, 12]
    assert latest_step(d) == 12
    assert restore_checkpoint(d)["w"].tolist() == [12.0, 12.0]
    assert restore_checkpoint(d, 7)["w"].tolist() == [7.0, 7.0]
    # a save of an existing step replaces it
    save_checkpoint(d, 9, {"w": torch.zeros(1)})
    assert restore_checkpoint(d, 9)["w"].tolist() == [0.0]
    assert all_steps(d) == [7, 9, 12]


def test_a_killed_save_is_not_a_step(tmp_path):
    """A save killed before its rename leaves its temporary directory
    (``.<step>-<random>``, state file written or not) behind: no step."""
    d = tmp_path / "ckpt"
    save_checkpoint(str(d), 2, {"w": torch.ones(1)})
    tmp = d / ".5-abc123"
    tmp.mkdir()
    torch.save({"w": torch.zeros(1)}, tmp / STATE_FILE)
    (d / "8").mkdir()          # a step directory without its state file
    assert latest_step(str(d)) == 2
    assert all_steps(str(d)) == [2]
    assert restore_checkpoint(str(d))["w"].tolist() == [1.0]


def test_restore_loads_weights_only(tmp_path):
    """A state that needs more than tensors, numbers, strings and
    containers fails loudly."""
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 0, {"w": torch.ones(1), "bad": AverageMeter()})
    with pytest.raises(Exception, match="(?i)weights_only|unpickl"):
        restore_checkpoint(d)


def test_trainer_core_is_one_process(tmp_path):
    with pytest.raises(ValueError, match="queue 1 item 10"):
        TrainerCore(use_mesh=True)
    with pytest.raises(ValueError, match="queue 1 item 10"):
        TrainerCore(mesh=object())
    core = TrainerCore(device="cpu")
    batch = {"x": torch.ones(2)}
    assert core.shard(batch) is batch and core.prepare(batch) is batch
    assert core.data_parallel_size == 1
    d = str(tmp_path / "ckpt")
    assert core.restore(d) is None and core.latest_step(d) is None
    core.save(d, 5, {"w": torch.arange(3.0)})
    assert core.latest_step(d) == 5
    assert core.restore(d)["w"].tolist() == [0.0, 1.0, 2.0]
    from video_mamba_suite_torch.tasks.tal import TalTrainer

    with pytest.raises(ValueError, match="queue 1 item 10"):
        TalTrainer(input_dim=8, num_classes=2, max_seq_len=32, embd_dim=16,
                   backbone_arch=(1, 1, 1),
                   regression_range=[(0, 4), (4, 100)], use_mesh=True,
                   device="cpu")


def test_watcher_latches_sigterm():
    with PreemptionWatcher() as w:
        assert not w.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert w.preempted
    # the handler is restored: a second watcher starts clean
    with PreemptionWatcher() as w2:
        assert not w2.preempted


def test_watcher_outside_the_main_thread_installs_nothing():
    import threading

    before = signal.getsignal(signal.SIGTERM)
    seen = {}

    def body():
        with PreemptionWatcher() as w:
            seen["preempted"] = w.preempted
            seen["handler"] = signal.getsignal(signal.SIGTERM)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == {"preempted": False, "handler": before}


def test_save_if_needed_periodic_and_preempt(tmp_path):
    core = TrainerCore()
    state = {"params": {"w": torch.arange(4.0)}, "step": torch.tensor(0)}
    d = str(tmp_path / "ckpt")
    with PreemptionWatcher() as w:
        # periodic save at step 0 (0 % 2 == 0), none at step 1
        assert w.save_if_needed(core, d, 0, state, every=2) is False
        assert core.latest_step(d) == 0
        assert w.save_if_needed(core, d, 1, state, every=2) is False
        assert core.latest_step(d) == 0
        # preemption: saves the current (off-schedule) step, returns True
        os.kill(os.getpid(), signal.SIGTERM)
        state["step"] = torch.tensor(7)
        assert w.save_if_needed(core, d, 7, state, every=2) is True
        assert core.latest_step(d) == 7
    assert int(core.restore(d)["step"]) == 7


def test_cli_ckpt_step_polls_watcher():
    from video_mamba_suite_torch import cli

    class FakeTrainer:
        saves = []

        def save(self, ckpt, ep):
            self.saves.append((ckpt, ep))

    tr = FakeTrainer()
    assert cli._ckpt_step(tr, None, 0) is False          # no watcher, no dir
    with PreemptionWatcher() as w:
        cli._WATCHER = w
        try:
            assert cli._ckpt_step(tr, "a-dir", 1) is False
            assert tr.saves == [("a-dir", 1)]
            os.kill(os.getpid(), signal.SIGTERM)
            assert cli._ckpt_step(tr, "a-dir", 2) is True  # stop + saved
            assert tr.saves[-1] == ("a-dir", 2)
        finally:
            cli._WATCHER = None


def test_meters_logger_and_timer(tmp_path, capsys, monkeypatch):
    # the JSONL stream alone: TensorBoard's import takes seconds
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    m = AverageMeter("loss", ":.2f")
    m.update(torch.tensor(2.0), n=3)
    m.update(4.0)
    assert (m.val, m.avg, m.count) == (4.0, 2.5, 4)
    assert str(m) == "loss 4.00 (2.50)"
    log = MetricLogger(str(tmp_path), name="run")
    log.log(3, {"loss": torch.tensor(0.5), "lr": 1e-3,
                "hist": torch.tensor([1.0, 2.0]), "tag": "a"}, prefix="t/")
    log.close()
    rec = json.loads((tmp_path / "run.jsonl").read_text().splitlines()[-1])
    assert rec["step"] == 3 and rec["t/loss"] == 0.5
    assert rec["t/hist"] == [1.0, 2.0] and rec["t/tag"] == "a"
    assert "[t/ 3] loss=0.5000 lr=0.0010" in capsys.readouterr().out
    timer = StepTimer()
    for _ in range(2):
        timer.start()
        timer.stop({"out": [torch.ones(2)]})
    assert timer.count == 2 and timer.avg_ms >= 0.0
    assert live_memory_bytes() is None or torch.cuda.is_available()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "tr").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_a_generator_state_of_another_device_kind_is_not_taken():
    """A card's Philox state (16 bytes) cannot continue on the CPU's
    Mersenne Twister: the generator keeps its stream, with a warning; a
    state of its own kind (also one moved to another device) is taken."""
    from video_mamba_suite_torch.utils.trainer import load_generator_state

    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    with pytest.warns(UserWarning, match="16-byte generator state"):
        load_generator_state(gen, torch.zeros(16, dtype=torch.uint8))
    assert torch.equal(gen.get_state(), before)
    other = torch.Generator().manual_seed(4)
    load_generator_state(gen, other.get_state())
    assert torch.equal(gen.get_state(), other.get_state())
