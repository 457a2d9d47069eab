"""Dense-captioning evaluation: dvc/para/SODA harnesses + sentence scorers.

The port's own copy of the JAX package's
``tasks/captioning/metrics.py``: pure Python and numpy, the same numbers.

Reference: upstream video-mamba-suite/video-dense-captioning/
densevid_eval3/ (evaluate2018.py / para_evaluate.py / eval_soda.py) +
eval_utils.py. `evaluate_dvc` and `evaluate_para` follow those protocols
EXACTLY (pair construction incl. garbage refs, per-video vs corpus scoring
granularity, PTB/parse_sent normalization) on the protocol-exact corpus
scorers in `scorers.py`; parity status and the one documented deviation
(METEOR jar → exact+Porter-stem METEOR, no WordNet/JVM here) are recorded
in PARITY.md. The sentence-level helpers below (bleu4 / rouge_l / cider_d)
are convenience utilities, NOT the protocol path.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np



def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu4(hyp: str, refs: List[str]) -> float:
    """Sentence BLEU-4 with brevity penalty + add-ε smoothing."""
    h = hyp.split()
    rs = [r.split() for r in refs]
    if not h:
        return 0.0
    max_n = min(4, len(h))  # short sentences: BLEU over available n-grams
    logp = 0.0
    for n in range(1, max_n + 1):
        hc = _ngrams(h, n)
        max_rc: Counter = Counter()
        for r in rs:
            rc = _ngrams(r, n)
            for k, v in rc.items():
                max_rc[k] = max(max_rc[k], v)
        clipped = sum(min(v, max_rc[k]) for k, v in hc.items())
        total = max(sum(hc.values()), 1)
        p = (clipped + 1e-9) / total
        logp += math.log(p) / max_n
    ref_len = min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
    bp = 1.0 if len(h) > ref_len else math.exp(1 - ref_len / max(len(h), 1))
    return bp * math.exp(logp)


def rouge_l(hyp: str, refs: List[str], beta: float = 1.2) -> float:
    """ROUGE-L F-measure (max over references)."""
    h = hyp.split()

    def lcs(a, b):
        dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
        for i in range(len(a)):
            for j in range(len(b)):
                dp[i + 1, j + 1] = (
                    dp[i, j] + 1 if a[i] == b[j]
                    else max(dp[i, j + 1], dp[i + 1, j])
                )
        return int(dp[-1, -1])

    best = 0.0
    for ref in refs:
        r = ref.split()
        if not h or not r:
            continue
        l = lcs(h, r)
        prec = l / len(h)
        rec = l / len(r)
        if prec + rec > 0:
            f = (1 + beta ** 2) * prec * rec / (rec + beta ** 2 * prec)
            best = max(best, f)
    return best


def cider_d(hyps: List[str], refs_list: List[List[str]], n: int = 4,
            sigma: float = 6.0) -> float:
    """Corpus CIDEr-D: tf-idf weighted n-gram cosine with length penalty."""
    M = len(hyps)
    # document frequency over the reference corpus
    df = [defaultdict(int) for _ in range(n)]
    for refs in refs_list:
        seen = [set() for _ in range(n)]
        for r in refs:
            toks = r.split()
            for k in range(n):
                seen[k] |= set(_ngrams(toks, k + 1).keys())
        for k in range(n):
            for g in seen[k]:
                df[k][g] += 1
    log_m = math.log(max(M, 1))

    def tfidf_vec(tokens, k):
        cnt = _ngrams(tokens, k + 1)
        total = max(sum(cnt.values()), 1)
        vec = {}
        for g, c in cnt.items():
            idf = log_m - math.log(max(df[k][g], 1))
            vec[g] = (c / total) * idf
        return vec

    def cos(a, b):
        num = sum(v * b.get(g, 0.0) for g, v in a.items())
        na = math.sqrt(sum(v * v for v in a.values()))
        nb = math.sqrt(sum(v * v for v in b.values()))
        return num / (na * nb) if na > 0 and nb > 0 else 0.0

    scores = []
    for hyp, refs in zip(hyps, refs_list):
        h_toks = hyp.split()
        s = 0.0
        for k in range(n):
            hv = tfidf_vec(h_toks, k)
            acc = 0.0
            for r in refs:
                r_toks = r.split()
                rv = tfidf_vec(r_toks, k)
                delta = len(h_toks) - len(r_toks)
                acc += cos(hv, rv) * math.exp(-(delta ** 2) / (2 * sigma ** 2))
            s += acc / max(len(refs), 1)
        scores.append(10.0 * s / n)
    return float(np.mean(scores)) if scores else 0.0


def _tiou(a: Sequence[float], b: Sequence[float]) -> float:
    """evaluate2018.py:91-97 — note the reference's union is
    min(hull, sum-of-lengths) with a +1e-8 stabilizer."""
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = min(max(a[1], b[1]) - min(a[0], b[0]),
                (a[1] - a[0]) + (b[1] - b[0]))
    return inter / (union + 1e-8)


def _as_gt_list(ground_truth) -> List[Dict[str, List[dict]]]:
    return ground_truth if isinstance(ground_truth, list) else [ground_truth]


def evaluate_dvc(
    predictions: Dict[str, List[dict]],   # vid → [{timestamp, sentence, score?}]
    ground_truth,                          # vid → [{timestamp, sentence}] or
                                           # a list of such dicts (multi-file)
    tious: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
    max_proposals: int = 1000,
    protocol: str = "2018",
) -> Dict[str, float]:
    """PROTOCOL-exact 2018/2021 evaluator (densevid_eval3/evaluate2018.py):

    Per tIoU: every (prediction, GT) pair with IoU ≥ tIoU becomes a scoring
    instance (ALL overlapping GTs, not just the best); predictions matching
    nothing are paired with a garbage reference — 'abc123!@#' under the
    2018 protocol (:205-210), a random 10–20-letter string under 2021
    (evaluate2021.py:213 — deterministic seeded here; either way it never
    matches). Captions are PTB-tokenized; each CORPUS scorer (scorers.py)
    runs once PER VIDEO over that video's instances, scores are averaged
    over videos (:229-247), then over tIoUs (eval_utils.py:131), ×100.
    METEOR uses the jar's 1.5 parametrization (scorers.meteor_corpus).

    Each video's prediction list is truncated to `max_proposals` first
    (evaluate2018.py:74, default 1000).

    Detection recall/precision (:127-158): per-video covered fractions with
    STRICT IoU > tIoU, best over GT files, averaged over videos and tIoUs.
    """
    from .scorers import (
        bleu_corpus,
        cider_corpus,
        meteor_corpus,
        ptb_tokenize,
        rouge_l_corpus,
    )

    if max_proposals is not None:
        predictions = {v: p[:max_proposals] for v, p in predictions.items()}
    if protocol == "2021":
        import random as _random
        import string as _string

        _rng = _random.Random(0x2021)

        def _garbage() -> str:
            return "".join(
                _rng.choice(_string.ascii_lowercase)
                for _ in range(_rng.randint(10, 20)))
    else:
        def _garbage() -> str:
            return "abc123!@#"

    gt_list = _as_gt_list(ground_truth)
    gt_vid_ids = sorted({v for gt in gt_list for v in gt.keys()})

    # --- detection (evaluate_detection): per-video best-over-gt-files
    det_recall, det_precision = [], []
    for tiou in tious:
        recs, precs = [], []
        for vid in gt_vid_ids:
            best_r = best_p = 0.0
            preds = predictions.get(vid, [])
            for gt in gt_list:
                if vid not in gt:
                    continue
                refs = gt[vid]
                ref_cov, pred_cov = set(), set()
                for pi, p in enumerate(preds):
                    for ri, g in enumerate(refs):
                        if _tiou(p["timestamp"], g["timestamp"]) > tiou:
                            ref_cov.add(ri)
                            pred_cov.add(pi)
                if preds:
                    best_p = max(best_p, len(pred_cov) / len(preds))
                best_r = max(best_r, len(ref_cov) / max(len(refs), 1))
            recs.append(best_r)
            precs.append(best_p)
        det_recall.append(float(np.mean(recs)) if recs else 0.0)
        det_precision.append(float(np.mean(precs)) if precs else 0.0)

    # --- captioning: per-tIoU pair building + per-video corpus scoring
    metric_acc: Dict[str, List[float]] = defaultdict(list)
    scorer_fns = [
        ("BLEU4", lambda g, r: bleu_corpus(g, r, 4)[0][3]),
        ("METEOR", lambda g, r: meteor_corpus(g, r)[0]),
        ("ROUGE_L", lambda g, r: rouge_l_corpus(g, r)[0]),
        ("CIDEr", lambda g, r: cider_corpus(g, r)[0]),
    ]
    for tiou in tious:
        vid_res: Dict[str, Dict[int, List[str]]] = {}
        vid_gts: Dict[str, Dict[int, List[str]]] = {}
        uid = 0
        for vid in gt_vid_ids:
            vid_res[vid] = {}
            vid_gts[vid] = {}
            for p in predictions.get(vid, []):
                added = False
                for gt in gt_list:
                    for g in gt.get(vid, []):
                        if _tiou(p["timestamp"], g["timestamp"]) >= tiou:
                            vid_res[vid][uid] = [ptb_tokenize(p["sentence"])]
                            vid_gts[vid][uid] = [ptb_tokenize(g["sentence"])]
                            uid += 1
                            added = True
                if not added:
                    vid_res[vid][uid] = [ptb_tokenize(p["sentence"])]
                    vid_gts[vid][uid] = [ptb_tokenize(_garbage())]
                    uid += 1
        for name, fn in scorer_fns:
            per_vid = [
                fn(vid_gts[v], vid_res[v]) if vid_res[v] else 0.0
                for v in gt_vid_ids
            ]
            metric_acc[name].append(float(np.mean(per_vid)) if per_vid
                                    else 0.0)

    out = {
        "recall": 100 * float(np.mean(det_recall)),
        "precision": 100 * float(np.mean(det_precision)),
    }
    for name, _ in scorer_fns:
        out[name] = 100 * float(np.mean(metric_acc[name]))
    return out


def _parse_sent(sent: str) -> str:
    """para_evaluate.py:26-29: strip non-letters, lowercase, re-join."""
    import re

    return " ".join(re.sub("[^a-zA-Z]", " ", sent).strip().lower().split())


def _bleu_n(hyp: str, refs: List[str], n: int) -> float:
    """Sentence BLEU-n (geometric mean of 1..n-gram precisions + BP)."""
    h = hyp.split()
    rs = [r.split() for r in refs if r.split()]
    if not h or not rs:
        return 0.0
    max_n = min(n, len(h))
    logp = 0.0
    for k in range(1, max_n + 1):
        hc = _ngrams(h, k)
        max_rc: Counter = Counter()
        for r in rs:
            for g, v in _ngrams(r, k).items():
                max_rc[g] = max(max_rc[g], v)
        clipped = sum(min(v, max_rc[g]) for g, v in hc.items())
        p = (clipped + 1e-9) / max(sum(hc.values()), 1)
        logp += math.log(p) / max_n
    ref_len = min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
    bp = 1.0 if len(h) > ref_len else math.exp(1 - ref_len / max(len(h), 1))
    return bp * math.exp(logp)


def evaluate_para(
    predictions: Dict[str, List[dict]],   # vid → [{sentence, ...}] in order
    para_ground_truth: "Dict[str, str] | List[Dict[str, str]]",
) -> Dict[str, float]:
    """PROTOCOL-exact paragraph evaluation (densevid_eval3/para_evaluate.py):
    per video, the predicted events' sentences are concatenated IN STORED
    ORDER ('sentence' + '. ', :77-80) into one paragraph, normalized with
    parse_sent (letters only, lowercase, :25-28), and the CORPUS scorers run
    ONCE over all videos (:130-137 — corpus BLEU/CIDEr/METEOR aggregate, not
    per-video means), ×100 (:182). Keys prefixed ``para_``. Videos missing
    from `predictions` score as empty hyps, exactly like the reference's
    `['']`.

    para_ground_truth: {vid: paragraph} or a list of such dicts (multiple
    reference files).
    """
    from .scorers import (
        bleu_corpus,
        cider_corpus,
        meteor_corpus,
        rouge_l_corpus,
    )

    gts_list = (
        para_ground_truth if isinstance(para_ground_truth, list)
        else [para_ground_truth]
    )
    vid_ids = sorted({v for gt in gts_list for v in gt.keys()})
    res: Dict[int, List[str]] = {}
    gts: Dict[int, List[str]] = {}
    for i, vid in enumerate(vid_ids):
        events = predictions.get(vid, [])
        para = "".join(e["sentence"] + ". " for e in events)
        res[i] = [_parse_sent(para)]
        gts[i] = [_parse_sent(gt[vid]) for gt in gts_list if vid in gt]
    out: Dict[str, float] = {}
    if not vid_ids:
        for n in range(1, 5):
            out[f"para_Bleu_{n}"] = 0.0
        out.update(para_METEOR=0.0, para_ROUGE_L=0.0, para_CIDEr=0.0)
        return out
    bleus, _ = bleu_corpus(gts, res, 4)
    for n in range(1, 5):
        out[f"para_Bleu_{n}"] = 100 * bleus[n - 1]
    out["para_METEOR"] = 100 * meteor_corpus(gts, res)[0]
    out["para_ROUGE_L"] = 100 * rouge_l_corpus(gts, res)[0]
    out["para_CIDEr"] = 100 * cider_corpus(gts, res)[0]
    return out


def rerank_predictions(
    predictions: Dict[str, List[dict]],
    alpha: float = 0.3,
    temperature: float = 2.0,
) -> Dict[str, List[dict]]:
    """Score reranking (eval_utils.py:144-166): joint_score =
    alpha·sentence_score/len(sentence)^temperature + proposal_score; keep the
    top `pred_event_count` (of the highest-joint-score event) proposals,
    re-sorted by timestamp. Events need `sentence_score`, `proposal_score`
    and `pred_event_count` fields (emitted by CaptioningTrainer.predict)."""
    out: Dict[str, List[dict]] = {}
    for vid, events in predictions.items():
        if not events:
            out[vid] = []
            continue
        scored = []
        for e in events:
            nwords = float(len(e["sentence"].split()))
            joint = (alpha * e["sentence_score"]
                     / (nwords ** temperature + 1e-5)
                     + e["proposal_score"])
            scored.append((joint, e))
        scored.sort(key=lambda t: t[0], reverse=True)
        top_n = int(scored[0][1].get("pred_event_count", len(scored)))
        kept = [e for _, e in scored[: max(top_n, 1)]]
        kept.sort(key=lambda e: e["timestamp"])
        out[vid] = kept
    return out


def soda_c(predictions: Dict[str, List[dict]],
           ground_truth: Dict[str, List[dict]]) -> float:
    """SODA-c (eval_soda.py:45): per-video optimal order-preserving
    matching (DP) of predictions to GT with reward = tIoU × METEOR.
    The protocol's pairwise METEOR is the 1.5 jar (pycocoevalcap) on
    PTB-tokenized captions — scored here with meteor.meteor15_pair (same
    parametrization; jar deviations documented in meteor.py/PARITY.md);
    F-measure averaged over videos."""
    from .meteor import meteor15_pair
    from .scorers import ptb_tokenize

    fs = []
    for vid, gts in ground_truth.items():
        preds = predictions.get(vid, [])
        if not preds or not gts:
            fs.append(0.0)
            continue
        n, m = len(preds), len(gts)
        ptoks = [ptb_tokenize(p["sentence"]) for p in preds]
        gtoks = [ptb_tokenize(g["sentence"]) for g in gts]
        score = np.zeros((n, m))
        for i, p in enumerate(preds):
            for j, g in enumerate(gts):
                iou = _tiou(p["timestamp"], g["timestamp"])
                if iou > 0.0:
                    score[i, j] = iou * meteor15_pair(ptoks[i], gtoks[j])
        # DP: order-preserving max-sum matching
        dp = np.zeros((n + 1, m + 1))
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                dp[i, j] = max(dp[i - 1, j], dp[i, j - 1],
                               dp[i - 1, j - 1] + score[i - 1, j - 1])
        total = dp[n, m]
        prec = total / n
        rec = total / m
        fs.append(2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)
    return 100 * float(np.mean(fs)) if fs else 0.0
