"""METEOR with exact + Porter-stem matching and the chunk fragmentation

The port's own copy of the JAX package's
``tasks/captioning/meteor.py``: pure Python and numpy, the same numbers.
penalty — the protocol-comparable scorer for dense-captioning eval.

Reference: the dense-captioning suite scores METEOR via the Java METEOR-1.5
jar (upstream video-mamba-suite/video-dense-captioning/densevid_eval3/
evaluate2018.py / evaluate2021.py → pycocoevalcap Meteor wrapper). The jar
is unavailable here (no JVM/WordNet); two pure-Python scoring functions are
provided:

* METEOR-1.5 semantics (Denkowski & Lavie 2014, "Meteor Universal" —
  the jar's English defaults, and THE PROTOCOL SCORER's parametrization):
  α=0.85, β=0.2, γ=0.6, δ=0.75; matcher stage weights exact=1.0, stem=0.6
  (synonym 0.8 / paraphrase 0.6 stages omitted — see deviations below);
  content/function-word-weighted precision and recall
    P = Σ_i w_i·(δ·m_i(h_c) + (1−δ)·m_i(h_f)) / (δ·|h_c| + (1−δ)·|h_f|)
  (recall analogously over the reference), F_mean = P·R/(α·P+(1−α)·R),
  fragmentation penalty γ·(chunks/matches)^β, score = F_mean·(1−penalty).
  This is the default for `evaluate_dvc` / SODA-c.
* METEOR-1.0 semantics (Banerjee & Lavie 2005; the parametrization
  nltk.translate.meteor_score replicates): α=0.9, β=3, γ=0.5, unweighted
  matches — kept for the nltk cross-validation conformance tests.

DOCUMENTED DEVIATIONS from the jar (all bounded in PARITY.md):
1. The WordNet synonym and paraphrase-table stages are omitted (no
   WordNet / paraphrase data in this environment) — one-sided: the jar can
   only match MORE, so our METEOR is a lower bound.
2. The function-word list is a curated English closed-class list
   (FUNCTION_WORDS below) instead of the jar's corpus-frequency-derived
   `data/function/en.words` (relative frequency > 1e-3). Caption
   vocabulary is dominated by clear content/function words, where the two
   lists agree.
3. Alignment is the sequential-stage greedy matcher (nltk's tie-break
   order) instead of the jar's beam search that jointly minimizes chunks;
   identical on the overwhelming majority of caption-length segments.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

_VOWELS = "aeiou"


def _is_consonant(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """The Porter 'm' value: number of VC sequences."""
    forms = []
    for i in range(len(stem)):
        forms.append("c" if _is_consonant(stem, i) else "v")
    s = "".join(forms)
    # collapse runs
    collapsed = []
    for ch in s:
        if not collapsed or collapsed[-1] != ch:
            collapsed.append(ch)
    return "".join(collapsed).count("vc")


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """Porter (1980) stemming algorithm, standard definition."""
    w = word.lower()
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _contains_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _contains_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
        # the step-4 "(s|t)ion" rule takes precedence as the longest match
        if _measure(w[:-3]) > 1:
            w = w[:-3]
    else:
        for suf in sorted(step4, key=len, reverse=True):
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if _measure(stem) > 1:
                    w = stem
                break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]
    return w


def _align_staged(
    hyp: Sequence[str], ref: Sequence[str],
) -> List[Tuple[int, int, int]]:
    """One-to-one (hyp_idx, ref_idx, stage) alignment via sequential
    stages: exact match (stage 0) first, then Porter-stem match (stage 1)
    on the leftovers (the jar's module order with the synonym/paraphrase
    stages omitted).

    Tie-breaking follows nltk.translate.meteor_score exactly (hypothesis
    words scanned DESCENDING, each matched to the LAST still-free reference
    occurrence) so the two independent implementations agree bit-for-bit
    on every sentence pair — the conformance test in
    tests/test_caption_protocol.py asserts this."""
    matches: List[Tuple[int, int, int]] = []
    h_free = set(range(len(hyp)))
    r_free = set(range(len(ref)))

    def stage(key, sidx):
        r_by_key = {}
        for j in sorted(r_free):
            r_by_key.setdefault(key(ref[j]), []).append(j)
        for i in sorted(h_free, reverse=True):
            k = key(hyp[i])
            if r_by_key.get(k):
                j = r_by_key[k].pop()
                matches.append((i, j, sidx))
                h_free.discard(i)
                r_free.discard(j)

    stage(lambda w: w, 0)
    stage(porter_stem, 1)
    return sorted(matches)


def _align(hyp: Sequence[str], ref: Sequence[str]) -> List[Tuple[int, int]]:
    return [(i, j) for i, j, _ in _align_staged(hyp, ref)]


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    """Fewest contiguous-in-both aligned spans (matches sorted by hyp idx)."""
    if not matches:
        return 0
    chunks = 1
    for (i0, j0), (i1, j1) in zip(matches, matches[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    return chunks


def meteor_stats(hypothesis: str, reference: str) -> Tuple[int, int, int, int]:
    """Alignment statistics of one pair: (matches, chunks, hyp_len, ref_len).

    The jar's system-level score sums these over segments before computing
    P/R/F-mean/penalty once (scorers.meteor_corpus); per-pair scoring
    derives from the same stats."""
    hyp = hypothesis.lower().split()
    ref = reference.lower().split()
    matches = _align(hyp, ref)
    return len(matches), _count_chunks(matches), len(hyp), len(ref)


def meteor_pair(hypothesis: str, reference: str, alpha: float = 0.9,
                beta: float = 3.0, gamma: float = 0.5) -> float:
    """METEOR score of one hypothesis/reference pair."""
    m, chunks, len_h, len_r = meteor_stats(hypothesis, reference)
    if m == 0 or len_h == 0 or len_r == 0:
        return 0.0
    precision = m / len_h
    recall = m / len_r
    f_mean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    penalty = gamma * (chunks / m) ** beta
    return f_mean * (1.0 - penalty)


def meteor(hypothesis: str, references: List[str], alpha: float = 0.9,
           beta: float = 3.0, gamma: float = 0.5) -> float:
    """Max over references (the multi-reference protocol)."""
    if not references:
        return 0.0
    return max(meteor_pair(hypothesis, r, alpha, beta, gamma)
               for r in references)


# ---------------------------------------------------------------------------
# METEOR 1.5 (Meteor Universal, Denkowski & Lavie 2014) — the jar's English
# scoring semantics: weighted matcher stages + content/function weighting.

# Curated English closed-class (function) word list, standing in for the
# jar's corpus-frequency-derived data/function/en.words (module docstring
# deviation 2). Includes the PTB clitic tokens the tokenizer produces.
FUNCTION_WORDS = frozenset("""
a an the
and or but nor so yet either neither both whether because although though
while if unless until since as than that whereas once
in on at by with from to of off over under above below between among
through during before after behind beside besides near against about
around across along down up out into onto upon within without toward
towards beneath despite per via
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs this these those who whom whose which what myself
yourself himself herself itself ourselves themselves yourselves one ones
someone anyone everyone something anything everything somebody anybody
everybody nothing none
am is are was were be been being do does did doing have has had having
will would shall should can could may might must
not no there here when where why how all each every some any few more
most other another such only own same just also too very then now
's n't 're 've 'll 'd 'm
""".split())

_STAGE_WEIGHTS = (1.0, 0.6)   # exact, stem (jar en defaults; syn .8 /
                              # paraphrase .6 stages omitted)


class Meteor15Stats(NamedTuple):
    """Segment alignment statistics, summable across segments the way the
    jar aggregates MeteorStats for its system-level score. Per stage s
    (0=exact, 1=stem): matched-word counts split content/function, on the
    hypothesis and reference sides."""

    m_h_content: Tuple[int, ...]
    m_h_function: Tuple[int, ...]
    m_r_content: Tuple[int, ...]
    m_r_function: Tuple[int, ...]
    chunks: int
    matches: int
    len_h_content: int
    len_h_function: int
    len_r_content: int
    len_r_function: int

    def __add__(self, other: "Meteor15Stats") -> "Meteor15Stats":  # type: ignore[override]
        return Meteor15Stats(
            tuple(a + b for a, b in zip(self.m_h_content, other.m_h_content)),
            tuple(a + b for a, b in
                  zip(self.m_h_function, other.m_h_function)),
            tuple(a + b for a, b in zip(self.m_r_content, other.m_r_content)),
            tuple(a + b for a, b in
                  zip(self.m_r_function, other.m_r_function)),
            self.chunks + other.chunks,
            self.matches + other.matches,
            self.len_h_content + other.len_h_content,
            self.len_h_function + other.len_h_function,
            self.len_r_content + other.len_r_content,
            self.len_r_function + other.len_r_function,
        )

    @classmethod
    def zero(cls) -> "Meteor15Stats":
        z = (0,) * len(_STAGE_WEIGHTS)
        return cls(z, z, z, z, 0, 0, 0, 0, 0, 0)


def meteor15_stats(hypothesis: str, reference: str) -> Meteor15Stats:
    hyp = hypothesis.lower().split()
    ref = reference.lower().split()
    matches = _align_staged(hyp, ref)
    ns = len(_STAGE_WEIGHTS)
    mhc, mhf = [0] * ns, [0] * ns
    mrc, mrf = [0] * ns, [0] * ns
    for i, j, s in matches:
        if hyp[i] in FUNCTION_WORDS:
            mhf[s] += 1
        else:
            mhc[s] += 1
        if ref[j] in FUNCTION_WORDS:
            mrf[s] += 1
        else:
            mrc[s] += 1
    hf = sum(1 for w in hyp if w in FUNCTION_WORDS)
    rf = sum(1 for w in ref if w in FUNCTION_WORDS)
    return Meteor15Stats(
        tuple(mhc), tuple(mhf), tuple(mrc), tuple(mrf),
        _count_chunks([(i, j) for i, j, _ in matches]), len(matches),
        len(hyp) - hf, hf, len(ref) - rf, rf,
    )


def meteor15_from_stats(
    st: Meteor15Stats, alpha: float = 0.85, beta: float = 0.2,
    gamma: float = 0.6, delta: float = 0.75,
) -> float:
    """Meteor Universal eqns (en task defaults α=.85 β=.2 γ=.6 δ=.75)."""
    if st.matches == 0:
        return 0.0
    wh = sum(w * (delta * c + (1 - delta) * f) for w, c, f in
             zip(_STAGE_WEIGHTS, st.m_h_content, st.m_h_function))
    wr = sum(w * (delta * c + (1 - delta) * f) for w, c, f in
             zip(_STAGE_WEIGHTS, st.m_r_content, st.m_r_function))
    dh = delta * st.len_h_content + (1 - delta) * st.len_h_function
    dr = delta * st.len_r_content + (1 - delta) * st.len_r_function
    if dh <= 0 or dr <= 0:
        return 0.0
    p, r = wh / dh, wr / dr
    if p == 0.0 or r == 0.0:
        return 0.0
    f_mean = p * r / (alpha * p + (1 - alpha) * r)
    penalty = gamma * (st.chunks / st.matches) ** beta
    return f_mean * (1.0 - penalty)


def meteor15_pair(hypothesis: str, reference: str, **kw) -> float:
    """METEOR-1.5 score of one hypothesis/reference pair."""
    return meteor15_from_stats(meteor15_stats(hypothesis, reference), **kw)
