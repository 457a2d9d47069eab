"""Protocol-exact corpus caption scorers (pycocoevalcap semantics).

The port's own copy of the JAX package's
``tasks/captioning/scorers.py``: pure Python and numpy, the same numbers.

The reference scores dense captioning through pycocoevalcap
(upstream video-mamba-suite/video-dense-captioning/densevid_eval3/
evaluate2018.py:16-20 imports PTBTokenizer/Bleu/Meteor/Rouge/Cider), whose
scorers are CORPUS-level: one `compute_score(gts, res)` call over a set of
instances returns an aggregate, not a mean of per-sentence scores. These are
re-implementations of those exact algorithms (from the published metric
definitions and the documented pycocoevalcap behavior — epsilon constants,
closest-reference length, idf quirks and all), so numbers are comparable 1:1
with the published tables wherever the algorithm can run in this environment.

Parity status (measured bounds in PARITY.md):
  * Bleu      — exact algorithm (closest-ref corpus BLEU, tiny/small eps).
  * Rouge     — exact (LCS F with beta=1.2, max precision/recall over refs
                combined AFTER the max — not max-F).
  * Cider     — exact (raw-tf·idf vectors, min-clipped numerator, per-call
                idf from the reference set, Gaussian length penalty, ×10).
  * Meteor    — METEOR-1.5 scoring semantics (the jar's English defaults:
                α=.85/β=.2/γ=.6/δ=.75, weighted exact+stem matcher stages,
                content/function-word weighting, 1.5 fragmentation penalty)
                with the jar's corpus aggregation (statistics summed over
                segments, score computed once from totals). Residual jar
                deviations — WordNet synonym/paraphrase stages omitted
                (one-sided: jar ≥ ours), curated function-word list, greedy
                stage alignment — documented in meteor.py + PARITY.md. The
                1.0 parametrization (α=.9/β=3/γ=.5, nltk-replicable) stays
                available via version="1.0" and is cross-validated
                bit-for-bit against nltk (tests/test_caption_protocol.py).
  * tokenizer — PTB approximation: lowercase, clitic splitting (n't/'s/…),
                punctuation tokens split off and the pycocoevalcap
                PUNCTUATIONS list removed. Exact on caption-style text.

Input convention (pycocoevalcap's): gts/res are {instance_id: [str, ...]}
with res holding exactly one hypothesis string per instance.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

from .meteor import meteor_pair, meteor_stats

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS — tokens the wrapper
# drops after the java tokenizer runs
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}


def remove_nonascii(text: str) -> str:
    """evaluate2018.py:24-25."""
    return "".join(c if ord(c) < 128 else " " for c in text)


def ptb_tokenize(text: str) -> str:
    """Approximation of the Stanford PTBTokenizer (-lowerCase) + the
    pycocoevalcap punctuation filter. Caption-style text (letters, digits,
    basic punctuation, simple clitics) tokenizes identically to the jar."""
    t = remove_nonascii(text).lower()
    t = re.sub(r"(\w)n't\b", r"\1 n't", t)          # don't → do n't
    t = re.sub(r"'(s|re|ve|ll|d|m)\b", r" '\1", t)  # clitics split
    t = re.sub(r"\.\.\.", " ... ", t)
    # remaining punctuation becomes its own token ("'": keep clitics intact)
    t = re.sub(r"([^\w\s'])", r" \1 ", t)
    t = re.sub(r"(?<![\w])'(?!(s|re|ve|ll|d|m)\b)", " ' ", t)
    return " ".join(w for w in t.split() if w not in PUNCTUATIONS)


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU — pycocoevalcap bleu_scorer.py semantics, option='closest'


def bleu_corpus(
    gts: Dict, res: Dict, n: int = 4,
) -> Tuple[List[float], List[List[float]]]:
    """Corpus BLEU_1..n + per-instance scores (pycocoevalcap Bleu).

    Per instance: clipped n-gram counts against the max reference count;
    reference length = the CLOSEST ref length (ties → shorter). Corpus
    score: cumulative-product precision chain with tiny=1e-15/small=1e-9
    epsilons, brevity penalty exp(1-1/ratio) when ratio < 1.
    """
    small, tiny = 1e-9, 1e-15
    tot_correct = [0] * n
    tot_guess = [0] * n
    tot_testlen = 0
    tot_reflen = 0
    per_instance: List[List[float]] = [[] for _ in range(n)]

    def instance_stats(hyp_tokens, ref_token_lists):
        correct, guess = [0] * n, [0] * n
        for k in range(1, n + 1):
            hc = _ngram_counts(hyp_tokens, k)
            max_rc: Counter = Counter()
            for r in ref_token_lists:
                for g, v in _ngram_counts(r, k).items():
                    max_rc[g] = max(max_rc[g], v)
            correct[k - 1] = sum(min(v, max_rc[g]) for g, v in hc.items())
            guess[k - 1] = max(0, len(hyp_tokens) - k + 1)
        testlen = len(hyp_tokens)
        reflen = min(
            (abs(len(r) - testlen), len(r)) for r in ref_token_lists
        )[1]
        return correct, guess, testlen, reflen

    def score_from(correct, guess, testlen, reflen):
        out = []
        bleu = 1.0
        for k in range(n):
            bleu *= (float(correct[k]) + tiny) / (float(guess[k]) + small)
            out.append(bleu ** (1.0 / (k + 1)))
        ratio = (testlen + tiny) / (reflen + small)
        if ratio < 1:
            bp = math.exp(1 - 1 / ratio)
            out = [s * bp for s in out]
        return out

    for iid in sorted(res.keys(), key=str):
        hyp = res[iid][0].split()
        refs = [r.split() for r in gts[iid]]
        correct, guess, testlen, reflen = instance_stats(hyp, refs)
        inst = score_from(correct, guess, testlen, reflen)
        for k in range(n):
            per_instance[k].append(inst[k])
            tot_correct[k] += correct[k]
            tot_guess[k] += guess[k]
        tot_testlen += testlen
        tot_reflen += reflen

    corpus = score_from(tot_correct, tot_guess, tot_testlen, tot_reflen)
    return corpus, per_instance


# ---------------------------------------------------------------------------
# ROUGE-L — pycocoevalcap rouge.py semantics


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_pair(hyp: str, refs: List[str], beta: float = 1.2) -> float:
    """One instance: max precision and max recall over refs taken
    SEPARATELY, then combined (the pycocoevalcap combine — not max-F)."""
    h = hyp.split()
    precs, recs = [], []
    for ref in refs:
        r = ref.split()
        if not h or not r:
            precs.append(0.0)
            recs.append(0.0)
            continue
        l = _lcs_len(h, r)
        precs.append(l / len(h))
        recs.append(l / len(r))
    pmax, rmax = max(precs, default=0.0), max(recs, default=0.0)
    if pmax == 0.0 or rmax == 0.0:
        return 0.0
    return (1 + beta ** 2) * pmax * rmax / (rmax + beta ** 2 * pmax)


def rouge_l_corpus(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    scores = [rouge_l_pair(res[i][0], gts[i])
              for i in sorted(res.keys(), key=str)]
    return (sum(scores) / len(scores) if scores else 0.0), scores


# ---------------------------------------------------------------------------
# CIDEr — pycocoevalcap cider_scorer.py semantics


def cider_corpus(
    gts: Dict, res: Dict, n: int = 4, sigma: float = 6.0,
) -> Tuple[float, List[float]]:
    """Corpus CIDEr: per-call idf from THIS reference set (df over each
    instance's union of ref n-grams, ref_len = log(#instances)); tf = RAW
    count × idf; numerator min-clipped against the ref vector; Gaussian
    length penalty per n; mean over n × 10; corpus = mean over instances.
    (With a single instance, log(1) = 0 makes every idf 0 and the score 0 —
    a quirk of the protocol scorer, reproduced.)"""
    ids = sorted(res.keys(), key=str)
    if not ids:
        return 0.0, []
    df: Dict[tuple, float] = defaultdict(float)
    for iid in ids:
        seen = set()
        for ref in gts[iid]:
            toks = ref.split()
            for k in range(1, n + 1):
                seen |= set(_ngram_counts(toks, k).keys())
        for g in seen:
            df[g] += 1
    ref_len = math.log(float(len(ids)))

    def counts2vec(tokens):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = len(tokens)
        for k in range(1, n + 1):
            for g, c in _ngram_counts(tokens, k).items():
                idf = ref_len - math.log(max(1.0, df[g]))
                vec[k - 1][g] = float(c) * idf
                norm[k - 1] += vec[k - 1][g] ** 2
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, vr, nh, nr, lh, lr):
        delta = float(lh - lr)
        val = [0.0] * n
        for k in range(n):
            for g, x in vh[k].items():
                val[k] += min(x, vr[k][g]) * vr[k][g]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for iid in ids:
        vh, nh, lh = counts2vec(res[iid][0].split())
        acc = [0.0] * n
        for ref in gts[iid]:
            vr, nr, lr = counts2vec(ref.split())
            for k, v in enumerate(sim(vh, vr, nh, nr, lh, lr)):
                acc[k] += v
        nrefs = max(len(gts[iid]), 1)
        scores.append(10.0 * sum(a / nrefs for a in acc) / n)
    return sum(scores) / len(scores), scores


# ---------------------------------------------------------------------------
# METEOR — jar-style corpus aggregation of the exact+stem scorer


def meteor_corpus(
    gts: Dict, res: Dict, alpha: float = None, beta: float = None,
    gamma: float = None, version: str = "1.5",
) -> Tuple[float, List[float]]:
    """Corpus METEOR the way the jar aggregates (pycocoevalcap Meteor
    returns the jar's system-level score): per segment pick the best
    reference, SUM its alignment statistics over all segments, then compute
    P/R/F-mean and the fragmentation penalty once from the totals. Segment
    scores (second return) use the same best-ref stats.

    version="1.5" (default — the protocol scorer's parametrization,
    α=.85/β=.2/γ=.6/δ=.75, weighted exact+stem stages, content/function
    weighting; meteor.meteor15_from_stats) or "1.0" (α=.9/β=3/γ=.5,
    unweighted — the parametrization the nltk cross-validation tests pin).
    See meteor.py's module docstring for the documented jar deviations.

    Zero-score tie rule: when EVERY reference scores 0 for a segment (e.g.
    the protocol's garbage-ref pairs), the FIRST reference's statistics
    enter the corpus totals — deterministic given the gts list order. The
    jar's choice among zero-scoring refs is likewise its iteration-first
    one; only hyp_len (shared) and the tiny ref_len of the unmatched ref
    differ across candidates, a sub-0.01-point corpus effect on the
    fixtures (PARITY.md)."""
    if version == "1.5":
        from .meteor import Meteor15Stats, meteor15_from_stats, meteor15_stats

        kw = {}
        if alpha is not None:
            kw["alpha"] = alpha
        if beta is not None:
            kw["beta"] = beta
        if gamma is not None:
            kw["gamma"] = gamma
        tot = Meteor15Stats.zero()
        seg_scores: List[float] = []
        for iid in sorted(res.keys(), key=str):
            hyp = res[iid][0]
            best, best_stats = 0.0, None
            for ref in gts[iid]:
                st = meteor15_stats(hyp, ref)
                s = meteor15_from_stats(st, **kw)
                if best_stats is None or s > best:
                    best, best_stats = s, st
            seg_scores.append(best)
            if best_stats is not None:
                tot = tot + best_stats
        return meteor15_from_stats(tot, **kw), seg_scores

    a = 0.9 if alpha is None else alpha
    b = 3.0 if beta is None else beta
    g = 0.5 if gamma is None else gamma
    tot_m = tot_ch = tot_lh = tot_lr = 0
    seg_scores = []
    for iid in sorted(res.keys(), key=str):
        hyp = res[iid][0]
        best, best_stats = 0.0, None
        for ref in gts[iid]:
            m, ch, lh, lr = meteor_stats(hyp, ref)
            s = _meteor_from_stats(m, ch, lh, lr, a, b, g)
            if best_stats is None or s > best:
                best, best_stats = s, (m, ch, lh, lr)
        seg_scores.append(best)
        if best_stats is not None:
            tot_m += best_stats[0]
            tot_ch += best_stats[1]
            tot_lh += best_stats[2]
            tot_lr += best_stats[3]
    return (_meteor_from_stats(tot_m, tot_ch, tot_lh, tot_lr,
                               a, b, g), seg_scores)


def _meteor_from_stats(m: int, chunks: int, len_h: int, len_r: int,
                       alpha: float, beta: float, gamma: float) -> float:
    if m == 0 or len_h == 0 or len_r == 0:
        return 0.0
    p = m / len_h
    r = m / len_r
    f = p * r / (alpha * p + (1 - alpha) * r)
    frag = chunks / m
    return f * (1.0 - gamma * frag ** beta)


__all__ = [
    "PUNCTUATIONS",
    "bleu_corpus",
    "cider_corpus",
    "meteor_corpus",
    "meteor_pair",
    "ptb_tokenize",
    "remove_nonascii",
    "rouge_l_corpus",
    "rouge_l_pair",
]
