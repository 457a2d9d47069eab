"""The suite's one launcher, for all seven tasks (the port's copy of the JAX
package's ``cli.py``, the L6 layer):

    python -m video_mamba_suite_torch.cli <task> [--preset NAME]
        [--synthetic] [--epochs N] [--ckpt DIR] [--set a.b=c ...]
        [--device cuda|cpu]

Real-data mode (the reference launchers' contract, e.g.
temporal-action-localization/train_eval.py:25-204) starts when the preset
and the overrides give the task's dataset paths:

    tas          --set dataset.features_path=... dataset.gt_path=...
                       dataset.vid_list=... dataset.mapping_file=...
    tal          --set dataset.json_file=... dataset.feat_folder=...
    vtg          --set dataset.train_jsonl=... dataset.v_feat_dirs=[...]
                       dataset.q_feat_dir=...
                 (highlight detection: dataset.highlight=true
                  dataset.label_dir=...)
    captioning   --set dataset.annotation_json=... dataset.feature_dir=...
    anticipation --set dataset.visual_dir=... dataset.target_dir=...
                       dataset.sessions=[...]

    recognition  --set dataset.train_csv=... dataset.video_root=...
    egocentric   --set dataset.metadata_json=... dataset.video_root=...
                 (MIR: train.mode=mir; classification: train.mode=cls
                  dataset.csv_path=... dataset.video_root=...)

The video modes decode each clip's frames on the host
(``data.video.VideoDecoder``: ``.npy`` frame arrays, or any video file a
decode backend reads) at the size the files hold, and recognition runs the
preset's RandAugment and random erasing there before every step. Without
paths (or with --synthetic) each task trains and evaluates on its built-in
synthetic dataset. --ckpt DIR checkpoints every
epoch and resumes from the newest epoch there; SIGTERM ends the run after
the epoch in flight, with its checkpoint on disk. Everything runs on the
card unless --device cpu asks for the plain versions on the CPU; without a
card, --device cuda raises.

The JAX CLI is the spec: each task builds what it builds, reads the keys
it reads (also where a preset keeps a value under another section) and
prints its lines.
"""

from __future__ import annotations

import argparse
import json
import os


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def _ds(cfg):
    return cfg.get("dataset", {})


def _has(cfg, *keys):
    d = _ds(cfg)
    return all(k in d for k in keys)


def _opt(cfg, key, default):
    return cfg.get("opt", {}).get(key, default)


def _mesh(cfg) -> bool:
    """train.use_mesh: data-parallel training (raises in the trainers: not
    ported yet)."""
    return bool(cfg.get("train", {}).get("use_mesh", False))


def _epoch_order(n, ep, seed=0):
    """The epoch-seeded sample order of one process (DistributedSampler
    semantics); batch_size is per process."""
    from .data.sampler import sharded_epoch_order

    return sharded_epoch_order(n, ep, seed)


_WATCHER = None  # the PreemptionWatcher main() installs; loops poll it


def _ckpt_step(tr, ckpt, ep) -> bool:
    """The epoch's checkpoint (with --ckpt) and the preemption poll:
    True stops the epoch loop after a latched SIGTERM, the finished
    epoch's checkpoint already on disk."""
    if ckpt:
        tr.save(ckpt, ep)
    return _WATCHER is not None and _WATCHER.preempted


def _maybe_resume(ckpt, restore_fn) -> int:
    """Resume from --ckpt's newest checkpoint when the directory has one.
    ``restore_fn`` runs the trainer's restore and returns the restored
    step or None. Returns the epoch to start from."""
    if not ckpt or not os.path.isdir(ckpt):
        return 0
    last = restore_fn()
    if last is None:
        return 0
    print(f"[resume] restored epoch {last} from {ckpt}", flush=True)
    return int(last) + 1


def run_tas(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    from .tasks.tas import TasTrainer
    from .tasks.tas.data import TasBatchGenerator, collate, \
        make_synthetic_dataset

    if not synthetic and _has(cfg, "features_path", "gt_path", "vid_list",
                              "mapping_file"):
        d, m = _ds(cfg), cfg.get("model", {})
        actions = {}
        with open(d["mapping_file"]) as f:
            for line in f.read().splitlines():
                if line.strip():
                    idx, name = line.split()
                    actions[name] = int(idx)
        nc = d.get("num_classes", len(actions))
        gen = TasBatchGenerator(
            nc, actions, d["gt_path"], d["features_path"],
            sample_rate=cfg.get("loader", {}).get("sample_rate", 1),
        )
        gen.read_data(d["vid_list"])
        tr = TasTrainer(
            num_classes=nc, input_dim=m.get("input_dim", 2048),
            num_layers=m.get("num_layers", 10),
            num_f_maps=m.get("num_f_maps", 64),
            num_decoders=m.get("num_decoders", 3),
            channel_masking_rate=m.get("channel_masking_rate", 0.3),
            lr=_opt(cfg, "learning_rate", 5e-4),
            weight_decay=_opt(cfg, "weight_decay", 1e-5),
            mixer=m.get("mixer", "vim"),
            use_mesh=_mesh(cfg), device=device,
        )
        bs = cfg.get("loader", {}).get("batch_size", 1)
        start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
        for ep in range(start, epochs):
            stats = tr.train_epoch(gen, batch_size=bs, if_warp=True)
            print(f"epoch {ep}: {stats}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        if "test_vid_list" in d:
            test = TasBatchGenerator(nc, actions, d["gt_path"],
                                     d["features_path"])
            test.read_data(d["test_vid_list"])
            items = [test._load_one(v) for v in test.list_of_examples]
            print("eval:", tr.evaluate(items))
        return

    data = make_synthetic_dataset(num_videos=8, num_classes=5, feat_dim=32)
    nc = max(int(l.max()) for _, l in data) + 1
    tr = TasTrainer(num_classes=nc, input_dim=32, num_layers=2, num_f_maps=32,
                    num_decoders=1, channel_masking_rate=0.0,
                    use_mesh=_mesh(cfg), device=device)

    class Gen:
        def __init__(s):
            s.i = 0

        def has_next(s):
            return s.i < len(data)

        def next_batch(s, bs, if_warp=False):
            c = data[s.i:s.i + bs]
            s.i += bs
            return collate(c, pad_to=16) + ([""] * len(c),)

        def reset(s):
            s.i = 0

    g = Gen()
    start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
    for ep in range(start, epochs):
        stats = tr.train_epoch(g, batch_size=2)
        print(f"epoch {ep}: {stats}")
        if _ckpt_step(tr, ckpt, ep):
            break
    print("eval:", tr.evaluate(data))


def run_tal(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    from .tasks.tal import TalTrainer
    from .tasks.tal.data import TalDataset, make_synthetic_tal

    if not synthetic and _has(cfg, "json_file", "feat_folder"):
        d, m = _ds(cfg), cfg.get("model", {})
        train_ds = TalDataset(
            d["json_file"], d["feat_folder"],
            split=d.get("train_split", ["training"]),
            feat_stride=d.get("feat_stride", 4),
            num_frames=d.get("num_frames", 16),
            default_fps=d.get("default_fps"),
            file_ext=d.get("file_ext", ".npy"),
            max_seq_len=d.get("max_seq_len", 2304), is_training=True,
        )
        val_ds = TalDataset(
            d["json_file"], d["feat_folder"],
            split=d.get("val_split", ["validation", "test"]),
            feat_stride=d.get("feat_stride", 4),
            num_frames=d.get("num_frames", 16),
            default_fps=d.get("default_fps"),
            file_ext=d.get("file_ext", ".npy"),
            max_seq_len=d.get("max_seq_len", 2304), is_training=False,
        )
        items = [train_ds[i] for i in range(len(train_ds))]
        bs = cfg.get("loader", {}).get("batch_size", 2)
        tr = TalTrainer(
            input_dim=d.get("input_dim", items[0]["feats"].shape[0]
                            if items else 2048),  # feats are (C, T)
            num_classes=d.get("num_classes", 20),
            max_seq_len=d.get("max_seq_len", 2304),
            embd_dim=m.get("embd_dim", 512),
            backbone_arch=tuple(m.get("backbone_arch", (2, 2, 5))),
            regression_range=m.get("regression_range"),
            lr=_opt(cfg, "learning_rate", 1e-4),
            weight_decay=_opt(cfg, "weight_decay", 0.05),
            warmup_steps=min(
                _opt(cfg, "warmup_epochs", 5) * max(len(items) // bs, 1),
                max(epochs * max(len(items) // bs, 1) // 2, 1)),
            total_steps=max(epochs, 1) * max(len(items) // bs, 1) + 1,
            mixer=m.get("mixer", "dbm"),
            test_cfg=cfg.get("test_cfg", {}).to_dict()
            if hasattr(cfg.get("test_cfg", {}), "to_dict") else None,
            use_mesh=_mesh(cfg), device=device,
        )
        start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
        for ep in range(start, epochs):
            stats = tr.train_epoch(items, batch_size=bs)
            print(f"epoch {ep}: {stats}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        val_items = [val_ds[i] for i in range(len(val_ds))]
        if val_items:
            mAP, avg = tr.evaluate(val_items)
            print(f"mAP per tIoU: {mAP}, avg {avg:.4f}")
        return

    items = make_synthetic_tal(num_videos=8, num_classes=2, feat_dim=16,
                               seq_len=128)
    tr = TalTrainer(input_dim=16, num_classes=2, max_seq_len=128, embd_dim=32,
                    backbone_arch=(1, 1, 2),
                    regression_range=[(0, 8), (8, 32), (32, 10000)],
                    lr=2e-3, warmup_steps=5, total_steps=epochs * 4,
                    device=device)
    start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
    for ep in range(start, epochs):
        stats = tr.train_epoch(items, batch_size=2)
        print(f"epoch {ep}: {stats}")
        if _ckpt_step(tr, ckpt, ep):
            break
    mAP, avg = tr.evaluate(items, tiou_thresholds=[0.3, 0.5], use_ema=False)
    print(f"mAP per tIoU: {mAP}, avg {avg:.3f}")


def run_vtg(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    from .tasks.vtg import VtgTrainer, make_synthetic_vtg
    from .tasks.vtg.data import load_file_dataset

    if _ds(cfg).get("highlight"):
        return run_vtg_hl(cfg, epochs, synthetic, ckpt, device)
    if not synthetic and _has(cfg, "train_jsonl", "v_feat_dirs", "q_feat_dir"):
        d, m = _ds(cfg), cfg.get("model", {})
        samples = load_file_dataset(
            d["train_jsonl"], d["v_feat_dirs"], d["q_feat_dir"],
            clip_len=d.get("clip_len", 2.0), max_v_l=d.get("max_v_l", 75),
        )
        tr = VtgTrainer(
            txt_dim=samples[0]["txt_feat"].shape[-1],
            vid_dim=samples[0]["vid_feat"].shape[-1],
            embed_dim=m.get("embed_dim", 256), depth=m.get("depth", 4),
            mamba_type=m.get("mamba_type", "vim"),
            lr=_opt(cfg, "learning_rate", 1e-4),
            max_q_l=d.get("max_q_l", 32), max_v_l=d.get("max_v_l", 75),
            use_mesh=_mesh(cfg), device=device,
        )
        bs = cfg.get("loader", {}).get("batch_size", 32)
        start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
        for ep in range(start, epochs):
            stats = tr.train_epoch(samples, batch_size=bs)
            print(f"epoch {ep}: {stats}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        if "eval_jsonl" in d:
            eval_samples = load_file_dataset(
                d["eval_jsonl"], d["v_feat_dirs"], d["q_feat_dir"],
                clip_len=d.get("clip_len", 2.0), max_v_l=d.get("max_v_l", 75),
            )
            print("eval:", tr.evaluate(eval_samples))
        return

    samples = make_synthetic_vtg(num_samples=16, ctx_l=32, txt_dim=12,
                                 vid_dim=12)
    tr = VtgTrainer(txt_dim=12, vid_dim=12, embed_dim=32, depth=2,
                    lr=5e-4, max_q_l=6, max_v_l=32, input_dropout=0.0,
                    device=device)
    start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
    for ep in range(start, epochs):
        stats = tr.train_epoch(samples, batch_size=4)
        print(f"epoch {ep}: {stats}")
        if _ckpt_step(tr, ckpt, ep):
            break
    print("eval:", tr.evaluate(samples))


def run_vtg_hl(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    """Highlight detection (train_hl.py): saliency-only training on one
    TVSum / YouTube-HL domain; eval = TVSum top-5 mAP over annotators.

    Real data: dataset.label_dir holds <vid>.npz with ``feat`` (T, D) and
    ``anno`` (T, n_ann), split by TVSUM_SPLITS[domain]. Synthetic: random
    features with planted high-saliency segments.
    """
    import numpy as np

    from .tasks.vtg.hl import HlTrainer, TVSUM_SPLITS, tvsum_map_at_k

    d, m = _ds(cfg), cfg.get("model", {})
    if not synthetic and _has(cfg, "label_dir"):
        domain = d.get("domain", "BK")
        split = TVSUM_SPLITS[domain]

        def load(vid):
            z = np.load(os.path.join(d["label_dir"], vid + ".npz"))
            anno = z["anno"].astype(np.float32)       # (T, n_ann)
            agg = anno.sum(1)
            return dict(vid_feat=z["feat"].astype(np.float32),
                        saliency=(agg > np.median(agg)).astype(np.float32),
                        anno=anno)
        train = [load(v) for v in split["train"]]
        val = [load(v) for v in split["val"]]
    else:
        T, Dv, n_ann = 64, 16, 20

        def synth(seed):
            r = np.random.default_rng(seed)
            feat = 0.1 * r.standard_normal((T, Dv)).astype(np.float32)
            anno = r.integers(0, 3, (T, n_ann)).astype(np.float32)
            s, e = 20, 36
            feat[s:e] += 1.0
            anno[s:e] += 3.0
            agg = anno.sum(1)
            return dict(vid_feat=feat, anno=anno,
                        saliency=(agg > np.median(agg)).astype(np.float32))
        train = [synth(i) for i in range(8)]
        val = [synth(100 + i) for i in range(2)]

    tr = HlTrainer(
        txt_dim=d.get("t_feat_dim", 512) if not synthetic else 8,
        vid_dim=train[0]["vid_feat"].shape[-1],
        embed_dim=m.get("embed_dim", 64 if synthetic else 256),
        depth=m.get("depth", 2 if synthetic else 4),
        mamba_type=m.get("mamba_type", "vim"),
        lr=_opt(cfg, "learning_rate", 1e-4),
        max_v_l=m.get("max_v_l", 128),
        use_mesh=_mesh(cfg), device=device,
    )
    bs = cfg.get("loader", {}).get("batch_size", 4)
    start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
    for ep in range(start, epochs):
        stats = tr.train_epoch(train, batch_size=bs)
        print(f"epoch {ep}: {stats}", flush=True)
        if _ckpt_step(tr, ckpt, ep):
            break
    scores = tr.predict_scores(val)
    m5 = tvsum_map_at_k(scores, [s["anno"] for s in val], k=5)
    print(f"eval: tvsum mAP@5 = {100 * m5:.2f}")


def run_captioning(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    import numpy as np

    from .tasks.captioning import CaptioningTrainer, PDVC, evaluate_dvc

    if not synthetic and _has(cfg, "annotation_json", "feature_dir"):
        from .tasks.captioning.data import (
            collate_captioning,
            load_activitynet_captions,
            vocab_list,
        )

        d, m = _ds(cfg), cfg.get("model", {})
        max_seq = d.get("max_seq_len", 256)
        items, tok = load_activitynet_captions(
            d["annotation_json"], d["feature_dir"],
            max_events=d.get("max_events", 10),
            max_caption_len=d.get("max_caption_len", 20),
            max_seq_len=max_seq,
        )
        model = PDVC(
            input_dim=items[0]["feats"].shape[-1],
            num_classes=1, vocab_size=tok.vocab_size,
            num_queries=m.get("num_queries", 100),
            d_model=m.get("d_model", 512), n_levels=m.get("n_levels", 4),
            num_encoder_layers=m.get("num_encoder_layers", 2),
            num_decoder_layers=m.get("num_decoder_layers", 6),
            max_caption_len=d.get("max_caption_len", 20),
            caption_decoder_type=m.get("caption_decoder_type", "light"),
            device=device,
        )
        tr = CaptioningTrainer(model, lr=_opt(cfg, "learning_rate", 5e-5),
                               use_mesh=_mesh(cfg))
        bs = cfg.get("loader", {}).get("batch_size", 1)
        start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
        for ep in range(start, epochs):
            order = _epoch_order(len(items), ep)
            for i in range(0, len(order) - bs + 1, bs):
                batch = [items[j] for j in order[i:i + bs]]
                losses = tr.train_step(*collate_captioning(batch, max_seq))
            print(f"epoch {ep}: {losses}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        # eval on the training annotations (a val json through --set
        # dataset.annotation_json on a second run)
        preds, gts = {}, {}
        vocab = vocab_list(tok)
        for i in range(0, len(items), bs):
            batch = items[i:i + bs]
            feats, mask, *_ = collate_captioning(batch, max_seq)
            events = tr.predict(feats, mask,
                                duration=float(batch[0]["duration"]),
                                vocab=vocab)
            for b, it in enumerate(batch):
                preds[it["video_id"]] = events[b]
                gts[it["video_id"]] = it["gt_events"]
        from .tasks.captioning import evaluate_para, rerank_predictions

        if d.get("rerank", False):  # eval_utils.py:125 (count_loss_coef > 0)
            preds = rerank_predictions(preds, alpha=d.get("alpha", 0.3))
        print("eval:", evaluate_dvc(preds, gts))
        # the paragraph leg: the ground-truth paragraphs are the events'
        # sentences joined (or dataset.para_annotation_json's)
        if d.get("para_annotation_json"):
            with open(d["para_annotation_json"]) as f:
                para_gt = json.load(f)
        else:
            para_gt = {v: ". ".join(e["sentence"] for e in g)
                       for v, g in gts.items()}
        print("para eval:", evaluate_para(preds, para_gt))
        return

    rng = np.random.default_rng(0)
    B, T, C = 2, 64, 12
    model = PDVC(input_dim=C, num_classes=1, vocab_size=12, num_queries=6,
                 d_model=32, n_levels=2, num_encoder_layers=1,
                 num_decoder_layers=2, max_caption_len=5, device=device)
    tr = CaptioningTrainer(model, lr=3e-4)
    feats = 0.2 * rng.standard_normal((B, T, C)).astype(np.float32)
    gt_boxes = np.zeros((B, 4, 2), np.float32)
    gt_labels = np.zeros((B, 4), np.int32)
    gt_valid = np.zeros((B, 4), bool)
    captions = np.full((B, 4, 6), -100, np.int64)
    gt_json = {}
    for b in range(B):
        s, e = 16 + 8 * b, 32 + 8 * b
        feats[b, s:e] += 2.0
        gt_boxes[b, 0] = [(s + e) / 2 / T, (e - s) / T]
        gt_valid[b, 0] = True
        captions[b, 0] = [0, 3, 4, 5, 6, 0]
        gt_json[f"v{b}"] = [dict(timestamp=[float(s), float(e)],
                                 sentence="3 4 5 6")]
    mask = np.ones((B, T), np.float32)
    for ep in range(epochs * 10):
        losses = tr.train_step(feats, mask, gt_boxes, gt_labels, gt_valid,
                               captions)
        if ep % 50 == 0:
            print(f"step {ep}: {losses}", flush=True)
    print("losses:", losses)
    events = tr.predict(feats, mask, duration=float(T), topk=3)
    print("eval:", evaluate_dvc({f"v{b}": events[b] for b in range(B)},
                                gt_json))


def run_anticipation(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    import numpy as np

    from .tasks.anticipation import AnticipationTrainer, LSTRMamba

    if not synthetic and _has(cfg, "visual_dir", "target_dir", "sessions"):
        from .tasks.anticipation.data import PerFrameDataset

        d, m = _ds(cfg), cfg.get("model", {})
        lm = m.get("long_memory_num_samples", 128)
        wm = m.get("work_memory_num_samples", 32)
        ant = m.get("anticipation_num_samples", 8)
        ds = PerFrameDataset(
            d["sessions"], d["visual_dir"], d.get("motion_dir"),
            d["target_dir"], long_memory=lm, work_memory=wm,
            anticipation=ant, stride=d.get("stride", wm),
        )
        vis0, mot0, _ = ds[0]
        model = LSTRMamba(
            visual_dim=vis0.shape[-1], motion_dim=mot0.shape[-1],
            d_model=m.get("d_model", 1024),
            num_classes=d.get("num_classes", 3806),
            long_memory_num_samples=lm, work_memory_num_samples=wm,
            anticipation_num_samples=ant,
            mamba_layers=m.get("mamba_layers", 2), device=device,
        )
        tr = AnticipationTrainer(model, lr=_opt(cfg, "learning_rate", 7e-5),
                                 use_mesh=_mesh(cfg))
        bs = cfg.get("loader", {}).get("batch_size", 16)
        start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
        for ep in range(start, epochs):
            for vis, mot, tgt in ds.batches(bs):
                loss = tr.train_step(vis, mot, tgt)
            print(f"epoch {ep}: loss {loss:.4f}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        return

    rng = np.random.default_rng(0)
    model = LSTRMamba(visual_dim=16, motion_dim=8, d_model=32, num_classes=3,
                      long_memory_num_samples=8, work_memory_num_samples=6,
                      anticipation_num_samples=2, mamba_layers=2,
                      device=device)
    T = 14
    P = 8
    protos = rng.standard_normal((3, 16)) * 2
    labels = rng.integers(0, 3, (16, P))
    visual = 0.3 * rng.standard_normal((16, T, 16)).astype(np.float32)
    for b in range(16):
        for p in range(6):
            visual[b, 8 + p] += protos[labels[b, p]]
        labels[b, 6:] = labels[b, 5]
    motion = np.zeros((16, T, 8), np.float32)
    tr = AnticipationTrainer(model, lr=2e-3)
    for ep in range(epochs * 5):
        loss = tr.train_step(visual, motion, labels.astype(np.int32))
        if ep % 25 == 0:
            print(f"step {ep}: loss {float(loss):.4f}", flush=True)
    print("loss:", loss, "eval:", tr.evaluate(visual, motion, labels))


def run_recognition(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    import numpy as np

    from .models.vivim import ViViM
    from .tasks.recognition import RecognitionTrainer

    if not synthetic and _has(cfg, "train_csv"):
        from .data.video_augment import make_train_augment
        from .data.video_datasets import VideoClassificationDataset

        d, m = _ds(cfg), cfg.get("model", {})
        ds = VideoClassificationDataset(
            d["train_csv"], d.get("video_root", ""),
            num_frames=m.get("num_frames", 16), is_training=True,
        )
        nc = d.get("num_classes", max(l for _, l in ds.items) + 1)
        size = d.get("crop_size", 224)
        model = ViViM(img_size=size, patch_size=16,
                      num_frames=m.get("num_frames", 16),
                      depth=m.get("depth", 24),
                      embed_dim=m.get("embed_dim", 192), num_classes=nc,
                      mixer=m.get("mixer", "vim"), device=device)
        tr = RecognitionTrainer(
            model, num_classes=nc, lr=_opt(cfg, "learning_rate", 1e-3),
            mixup_alpha=cfg.get("aug", {}).get("mixup", 0.8),
            cutmix_alpha=cfg.get("aug", {}).get("cutmix", 1.0),
            use_mesh=_mesh(cfg),
        )
        # the preset's RandAugment and random erasing (the K400 recipe,
        # kinetics_sparse.py upstream), on the host before every step
        aug_fn = make_train_augment(cfg.get("aug", {}))
        bs = cfg.get("loader", {}).get("batch_size", 8)
        rng = np.random.default_rng(0)

        def restore():
            ds[0]                  # the JAX CLI's restore samples a clip
            return tr.restore(ckpt)

        start = _maybe_resume(ckpt, restore)
        for ep in range(start, epochs):
            order = _epoch_order(len(ds), ep)
            for i in range(0, len(order) - bs + 1, bs):
                rows = [ds[j] for j in order[i:i + bs]]
                if aug_fn is not None:
                    videos = np.stack([
                        aug_fn(r["frames"][0].astype(np.uint8), rng)
                        for r in rows])
                else:
                    videos = np.stack([
                        r["frames"][0].astype(np.float32) / 255.0
                        for r in rows])
                labels = np.array([r["label"] for r in rows], np.int32)
                loss = tr.train_step(videos, labels)
            print(f"epoch {ep}: loss {loss:.4f}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        return

    rng = np.random.default_rng(0)
    n, S = 16, 32
    labels = rng.integers(0, 3, n)
    xs = np.linspace(0, 2 * np.pi, S)
    videos = np.zeros((n, 2, S, S, 3), np.float32)
    for i, c in enumerate(labels):
        pat = np.sin((c + 1) * xs)[None, :] * np.cos((c + 1) * xs)[:, None]
        videos[i] = pat[None, :, :, None] + 0.2 * rng.standard_normal(
            (2, S, S, 3))
    model = ViViM(img_size=S, patch_size=8, num_frames=2, depth=2,
                  embed_dim=32, num_classes=3, drop_path_rate=0.0,
                  device=device)
    tr = RecognitionTrainer(model, num_classes=3, lr=2e-3, mixup_alpha=0.0,
                            cutmix_alpha=0.0, smoothing=0.0)
    start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
    for ep in range(start, epochs):
        for i in range(0, n, 8):
            loss = tr.train_step(videos[i:i + 8], labels[i:i + 8])
        print(f"epoch {ep}: loss {loss:.4f}")
        if _ckpt_step(tr, ckpt, ep):
            break
    print("eval:", tr.evaluate(videos, labels))


def _synthetic_clip(device):
    """The CLIP of the egocentric synthetic tasks: ViViM towers of width 32
    at 2 frames of 32², a 2-layer text tower."""
    from .models.clip import CLIP

    return CLIP(
        embed_dim=16, vision_tower="vivim",
        vision_cfg=dict(img_size=32, patch_size=16, num_frames=2, depth=2,
                        embed_dim=32),
        text_cfg=dict(context_length=8, vocab_size=50, width=32, heads=4,
                      layers=2),
        device=device,
    )


def _synthetic_pairs():
    """4 clips of constant level i / 4 with noise, and captions of the
    token i + 1."""
    import numpy as np

    rng = np.random.default_rng(0)
    videos = np.stack([
        np.full((2, 32, 32, 3), i / 4.0, np.float32)
        + 0.05 * rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        for i in range(4)
    ])
    texts = np.stack([np.full((8,), i + 1, np.int64) for i in range(4)])
    return videos, texts


def _run_ego_mir(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    """EK100 MIR fine-tuning (main_lavila_finetune_mir.py): contrastive
    fine-tuning and the retrieval mAP / nDCG."""
    import numpy as np

    from .tasks.egocentric.finetune import MirFinetuner

    m = cfg.get("model", {})
    if not synthetic and _has(cfg, "metadata_json", "video_root"):
        from .data.tokenizer import WordTokenizer
        from .data.video_datasets import VideoCaptionDataset

        d = _ds(cfg)
        with open(d["metadata_json"]) as f:
            metadata = json.load(f)
        tok = WordTokenizer(corpus=[x.get("caption", "") for x in metadata],
                            context_length=d.get("context_length", 77))
        ds = VideoCaptionDataset(metadata, d["video_root"],
                                 num_frames=m.get("num_frames", 4))
        model = _build_ego_clip(cfg, tok.vocab_size, device)
        ft = MirFinetuner(model, lr=_opt(cfg, "learning_rate", 1e-5),
                          weight_decay=_opt(cfg, "weight_decay", 0.01),
                          use_mesh=_mesh(cfg))
        bs = cfg.get("loader", {}).get("batch_size", 8)

        def batch(rows):
            videos = np.stack(
                [r["frames"].astype(np.float32) / 255.0 for r in rows])
            texts = np.stack([np.asarray(tok([r["caption"]])[0], np.int64)
                              for r in rows])
            return videos, texts

        batch([ds[0]])             # the JAX CLI's restore sample
        start = _maybe_resume(ckpt, lambda: ft.restore(ckpt))
        for ep in range(start, epochs):
            order = _epoch_order(len(ds), ep)
            for i in range(0, len(order) - bs + 1, bs):
                videos, texts = batch([ds[j] for j in order[i:i + bs]])
                loss = ft.train_step(videos, texts)
            print(f"epoch {ep}: loss {loss:.4f}", flush=True)
            if _ckpt_step(ft, ckpt, ep):
                break
        # retrieval over the training clips (another set through --set
        # dataset.metadata_json on a second run)
        videos, texts = batch([ds[i] for i in range(len(ds))])
        rel = np.load(d["relevancy_npy"]) if "relevancy_npy" in d else \
            np.eye(len(ds), dtype=np.float32)
        print("eval:", ft.evaluate(videos, texts, rel, batch_size=bs))
        return

    model = _synthetic_clip(device)
    ft = MirFinetuner(model, lr=1e-3, use_mesh=_mesh(cfg))
    videos, texts = _synthetic_pairs()
    for step in range(epochs * 10):
        loss = ft.train_step(videos, texts)
        if step == 0 or (step + 1) % 50 == 0:
            print(f"step {step}: loss {loss:.4f}", flush=True)
    res = ft.evaluate(videos, texts, np.eye(4, dtype=np.float32),
                      batch_size=4)
    print(f"loss {loss:.4f}, avg_map {res['avg_map']:.2f}, "
          f"avg_ndcg {res['avg_ndcg']:.2f}")


def _run_ego_cls(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    """EK100 action classification (main_lavila_finetune_cls.py): a
    classifier head on the video tower, the smoothed / mixed
    cross-entropy, the verb / noun marginals."""
    import numpy as np

    from .models.vivim import ViViM
    from .tasks.egocentric.finetune import ClsFinetuner

    m = cfg.get("model", {})
    if not synthetic and _has(cfg, "csv_path", "video_root"):
        from .data.video_datasets import VideoClassificationDataset

        d = _ds(cfg)
        ds = VideoClassificationDataset(
            d["csv_path"], d["video_root"],
            num_frames=m.get("num_frames", 16))
        # the default is computed whether or not it is needed, as in the
        # JAX CLI: it decodes (and samples) every clip once
        nc = d.get("num_classes", 1 + max(ds[i]["label"]
                                          for i in range(len(ds))))
        tower = ViViM(img_size=m.get("img_size", 224),
                      patch_size=m.get("patch_size", 16),
                      num_frames=m.get("num_frames", 16),
                      depth=m.get("depth", 24),
                      embed_dim=m.get("embed_dim", 192), num_classes=0,
                      device=device)
        bs = cfg.get("loader", {}).get("batch_size", 8)
        steps = max(len(ds) // bs, 1) * max(epochs, 1)
        ft = ClsFinetuner(
            tower, num_classes=nc, lr=_opt(cfg, "learning_rate", 1e-4),
            weight_decay=_opt(cfg, "weight_decay", 0.05),
            smoothing=cfg.get("aug", {}).get("smoothing", 0.1),
            mixup_alpha=cfg.get("aug", {}).get("mixup", 0.0),
            cutmix_alpha=cfg.get("aug", {}).get("cutmix", 0.0),
            warmup_steps=min(steps // 10 + 1, 100), total_steps=steps,
            use_mesh=_mesh(cfg))
        ds[0]                      # the JAX CLI's restore sample
        start = _maybe_resume(ckpt, lambda: ft.restore(ckpt))
        for ep in range(start, epochs):
            order = _epoch_order(len(ds), ep)
            for i in range(0, len(order) - bs + 1, bs):
                rows = [ds[j] for j in order[i:i + bs]]
                videos = np.stack(
                    [r["frames"][0].astype(np.float32) / 255.0 for r in rows])
                labels = np.asarray([r["label"] for r in rows], np.int32)
                loss = ft.train_step(videos, labels)
            print(f"epoch {ep}: loss {loss:.4f}", flush=True)
            if _ckpt_step(ft, ckpt, ep):
                break
        videos = np.stack([ds[i]["frames"][0].astype(np.float32) / 255.0
                           for i in range(len(ds))])
        labels = np.asarray([ds[i]["label"] for i in range(len(ds))],
                            np.int32)
        print("eval:", ft.evaluate(videos, labels))
        return

    rng = np.random.default_rng(2)
    n, n_act = 12, 4
    videos = rng.standard_normal((n, 2, 16, 16, 3)).astype(np.float32)
    labels = (np.arange(n) % n_act).astype(np.int32)
    for i, l in enumerate(labels):
        videos[i] += 2.0 * (l - 1.5)
    tower = ViViM(img_size=16, patch_size=8, num_frames=2, depth=1,
                  embed_dim=16, num_classes=0, device=device)
    ft = ClsFinetuner(tower, num_classes=n_act, lr=1e-2, dropout=0.0,
                      smoothing=0.0, warmup_steps=5, total_steps=300,
                      use_mesh=_mesh(cfg))
    for _ in range(epochs * 10):
        loss = ft.train_step(videos, labels)
    res = ft.evaluate(videos, labels)
    print(f"loss {loss:.4f}, action top-1 {res['action_top1']:.1f}")


def _build_ego_clip(cfg, vocab_size, device):
    """The CLIP of the egocentric real-data modes, from the config's
    ``model`` and ``dataset`` keys as the JAX CLI reads them. A TimeMamba
    tower takes its spatial attention on K10 (``attn_flash="row"``) where
    the JAX CLI's takes the einsum path (the same function), and has no
    ``scan_blocks`` (a JAX compile-time device, not ported)."""
    from .models.clip import CLIP

    m, d = cfg.get("model", {}), _ds(cfg)
    tower = m.get("vision_tower", "timemamba")
    vision_cfg = dict(num_frames=m.get("num_frames", 4),
                      depth=m.get("depth", 12),
                      embed_dim=m.get("vision_width", 768),
                      img_size=m.get("img_size", 224),
                      patch_size=m.get("patch_size", 16))
    if tower == "timemamba":
        vision_cfg.update(
            ln_pre=True,
            attention_style=m.get("attention_style", "frozen-in-time"),
            is_tanh_gating=m.get("is_tanh_gating", False),
            attn_flash="row")
    return CLIP(
        embed_dim=m.get("embed_dim", 512),
        vision_tower=tower,
        vision_cfg=vision_cfg,
        text_cfg=dict(context_length=d.get("context_length", 77),
                      vocab_size=vocab_size,
                      width=m.get("text_width", 512),
                      heads=m.get("text_heads", 8),
                      layers=m.get("text_layers", 12)),
        device=device,
    )


def run_egocentric(cfg, epochs, synthetic, ckpt=None, device="cuda"):
    import numpy as np

    from .tasks.egocentric import ClipPretrainer

    # the engine (upstream ships three mains: main_lavila_pretrain.py,
    # _finetune_mir.py and _finetune_cls.py)
    mode = cfg.get("train", {}).get("mode", "pretrain")
    if mode == "mir":
        return _run_ego_mir(cfg, epochs, synthetic, ckpt, device)
    if mode == "cls":
        return _run_ego_cls(cfg, epochs, synthetic, ckpt, device)

    if not synthetic and _has(cfg, "metadata_json", "video_root"):
        from .data.tokenizer import WordTokenizer
        from .data.video_datasets import VideoCaptionDataset

        d, m = _ds(cfg), cfg.get("model", {})
        with open(d["metadata_json"]) as f:
            metadata = json.load(f)
        tok = WordTokenizer(corpus=[x.get("caption", "") for x in metadata],
                            context_length=d.get("context_length", 77))
        ds = VideoCaptionDataset(metadata, d["video_root"],
                                 num_frames=m.get("num_frames", 4))
        model = _build_ego_clip(cfg, tok.vocab_size, device)
        tr = ClipPretrainer(model, lr=_opt(cfg, "learning_rate", 3e-5),
                            use_mesh=_mesh(cfg))
        bs = cfg.get("loader", {}).get("batch_size", 8)
        ds[0]                      # the JAX CLI's restore sample
        start = _maybe_resume(ckpt, lambda: tr.restore(ckpt))
        for ep in range(start, epochs):
            order = _epoch_order(len(ds), ep)
            for i in range(0, len(order) - bs + 1, bs):
                rows = [ds[j] for j in order[i:i + bs]]
                videos = np.stack(
                    [r["frames"].astype(np.float32) / 255.0 for r in rows])
                texts = np.stack([
                    np.asarray(tok([r["caption"]])[0], np.int64)
                    for r in rows])
                loss = tr.train_step(videos, texts)
            print(f"epoch {ep}: loss {loss:.4f}", flush=True)
            if _ckpt_step(tr, ckpt, ep):
                break
        return

    model = _synthetic_clip(device)
    tr = ClipPretrainer(model, lr=1e-3)
    videos, texts = _synthetic_pairs()
    for step in range(epochs * 10):
        loss = tr.train_step(videos, texts)
    img, txt, _ = tr.encode(videos, texts)
    acc = float((np.argmax(img @ txt.T, 1) == np.arange(4)).mean())
    print(f"loss {loss:.4f}, retrieval acc {acc:.2f}")


TASKS = {
    "tas": run_tas, "tal": run_tal, "vtg": run_vtg,
    "captioning": run_captioning, "anticipation": run_anticipation,
    "recognition": run_recognition, "egocentric": run_egocentric,
}


def main(argv=None):
    from .configs import PRESETS
    from .utils.config import Config
    from .utils.preemption import PreemptionWatcher

    p = argparse.ArgumentParser(prog="video_mamba_suite_torch")
    p.add_argument("task", choices=sorted(TASKS))
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--synthetic", action="store_true",
                   help="force the built-in synthetic dataset even when "
                        "dataset paths are configured")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory (a save per epoch; resumes "
                        "from its newest)")
    p.add_argument("--set", nargs="*", dest="overrides",
                   help="dotted config overrides a.b=c")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default; raises without one) or the "
                        "plain versions on the CPU")
    args = p.parse_args(argv)

    cfg = Config(PRESETS[args.preset]) if args.preset else Config()
    cfg = cfg.override(_parse_overrides(args.overrides))

    global _WATCHER
    with PreemptionWatcher() as _WATCHER:
        try:
            TASKS[args.task](cfg, args.epochs, args.synthetic,
                             ckpt=args.ckpt, device=args.device)
        finally:
            _WATCHER = None


if __name__ == "__main__":
    main()
