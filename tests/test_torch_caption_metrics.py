"""The port's dense-captioning metrics against the JAX package's, exactly:
the Porter stemmer and METEOR (1.0 and 1.5), the corpus scorers (BLEU,
ROUGE-L, CIDEr, METEOR, the PTB tokenizer), the sentence helpers, and the
protocol evaluators ``evaluate_dvc`` (2018 and 2021), ``soda_c``,
``evaluate_para`` and ``rerank_predictions``. The cases are those of the
JAX package's ``tests/test_caption_protocol.py`` and ``tests/test_meteor.py``
and random prediction and reference sets from a seed. Both sides are host
Python: every number is compared with ``==``."""

import random

import numpy as np
import pytest
import torch

from video_mamba_suite_tpu.tasks.captioning import meteor as jax_meteor
from video_mamba_suite_tpu.tasks.captioning import metrics as jax_metrics
from video_mamba_suite_tpu.tasks.captioning import scorers as jax_scorers
from video_mamba_suite_torch.tasks.captioning import meteor, metrics, scorers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """No tensors here; one intra-op thread keeps this file's worker from
    taking cores the test workers beside it use."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the stemmer vocabulary of the JAX protocol test and Porter's cases
_STEMS = """running cooked cooking cooks jumps jumping quickly slowly
happiness caresses ponies ties caress cats feed agreed plastered bled
motoring sing conflated troubled sized hopping tanned falling hissing fizzed
failing filing relational conditional rational valenci hesitanci digitizer
conformabli radicalli differentli vileli analogousli vietnamization
predication operator feudalism decisiveness hopefulness callousness formaliti
sensitiviti sensibiliti triplicate formative formalize electriciti electrical
hopeful goodness revival allowance inference airliner gyroscopic adjustable
defensible irritant replacement adjustment dependent adoption homologou
communism activate angulariti homologi effective bowdlerize probate rate
cease controll roll skies sky die dying lying tying news innings proceed
exceed succeed happy generalizations oscillators""".split()

_WORDS = ("the a man dog cat runs running jumped jumps over quick quickly "
          "brown lazy eats cooking cooked food ball park happy he she it "
          "is are in on of and . , !").split()

# the JAX tests' sentence pairs
_PAIRS = [
    ("the cat sat on the mat", "the cat sat on the mat"),
    ("on the mat sat the cat", "the cat sat on the mat"),
    ("he runs fast", "he jumped quickly"),
    ("the dog running home", "the dog runs home"),
    ("alpha beta", "gamma delta"),
    ("the cat", "the cat sat on the mat"),
    ("the cat sat on the mat", "the cat"),
    ("a man cooks", "a man cooks"),
    ("the the cat", "the cat"),
    ("", "a man cooks"),
]


def _sentence(rng, lo=0, hi=12):
    return " ".join(rng.choice(_WORDS) for _ in range(rng.randint(lo, hi)))


def _dvc_sets(seed, videos=5):
    """Random predictions (with scores, proposal and sentence scores) and
    ground truth over ``videos`` videos of 60 s: overlapping, disjoint and
    empty cases."""
    rng = random.Random(seed)
    preds, gts = {}, {}
    for v in range(videos):
        gt = []
        for _ in range(rng.randint(1, 4)):
            s = rng.uniform(0, 50)
            gt.append(dict(timestamp=[s, s + rng.uniform(2, 10)],
                           sentence=_sentence(rng, 1)))
        gts[f"v{v}"] = gt
        if v == videos - 1:
            continue                       # a video without predictions
        pred = []
        for _ in range(rng.randint(1, 6)):
            s = rng.uniform(0, 55)
            words = _sentence(rng)
            pred.append(dict(timestamp=[s, s + rng.uniform(1, 12)],
                             sentence=words, score=rng.random(),
                             proposal_score=rng.random(),
                             sentence_score=-rng.uniform(0, 5)
                             * max(len(words.split()), 1)))
        preds[f"v{v}"] = pred
    return preds, gts


@pytest.mark.parametrize("chunk", range(4))
def test_porter_stem(chunk):
    words = _STEMS[chunk::4]
    assert [meteor.porter_stem(w) for w in words] == \
        [jax_meteor.porter_stem(w) for w in words]


@pytest.mark.parametrize("version", ["1.0", "1.5"])
def test_meteor_pairs(version):
    """The JAX tests' pairs and 200 random ones: METEOR 1.0 (with its
    alignment statistics) or the 1.5 parametrization."""
    rng = random.Random(1)
    pairs = _PAIRS + [(_sentence(rng, 1), _sentence(rng, 1))
                      for _ in range(200)]
    for h, r in pairs:
        if version == "1.0":
            if h:
                assert meteor.meteor_stats(h, r) == \
                    jax_meteor.meteor_stats(h, r)
            assert meteor.meteor_pair(h, r) == jax_meteor.meteor_pair(h, r)
        else:
            assert meteor.meteor15_stats(h, r) == \
                jax_meteor.meteor15_stats(h, r)
            assert meteor.meteor15_pair(h, r) == \
                jax_meteor.meteor15_pair(h, r)
    refs = ["completely unrelated text", "a man plays guitar"]
    assert meteor.meteor("a man plays guitar", refs) == \
        jax_meteor.meteor("a man plays guitar", refs)
    assert meteor.meteor("a b", []) == jax_meteor.meteor("a b", [])


def test_alignment_and_chunks():
    for h, r in _PAIRS[:9]:
        m = meteor._align(h.split(), r.split())
        assert m == jax_meteor._align(h.split(), r.split())
        assert meteor._count_chunks(sorted(m)) == \
            jax_meteor._count_chunks(sorted(m))


@pytest.mark.parametrize("text", [
    "A man's dog doesn't run, he said.", "café au lait!", "abc123!@#",
    "  Two   spaces -- and (brackets) ", "It's 5 o'clock; they'll go.",
])
def test_ptb_tokenize(text):
    assert scorers.ptb_tokenize(text) == jax_scorers.ptb_tokenize(text)


def _corpus(seed, n=6):
    rng = random.Random(seed)
    gts = {i: [_sentence(rng, 1) for _ in range(rng.randint(1, 3))]
           for i in range(n)}
    res = {i: [_sentence(rng, 0)] for i in range(n)}
    res[0] = [gts[0][0]]                     # one perfect instance
    return gts, res


@pytest.mark.parametrize("scorer", ["bleu", "rouge", "cider", "meteor",
                                    "meteor-1.0"])
@pytest.mark.parametrize("seed", [2, 3])
def test_corpus_scorers(scorer, seed):
    """Each corpus scorer on a random corpus and on the JAX tests' golden
    corpora: the aggregate and every instance's score."""
    cases = [_corpus(seed),
             ({0: ["a man cooks"]}, {0: ["a man cooks"]}),
             ({0: ["a b"], 1: ["c d"]}, {0: ["a b"], 1: ["c d"]}),
             ({0: ["the cat sat on a mat", "there is a cat on the mat"],
               1: ["the quick brown fox jumped over a lazy dog"]},
              {0: ["the cat sat on the mat"],
               1: ["a quick brown fox jumps over the lazy dog"]})]
    for gts, res in cases:
        if scorer == "bleu":
            got, want = (f(gts, res, 4) for f in (scorers.bleu_corpus,
                                                   jax_scorers.bleu_corpus))
        elif scorer == "rouge":
            got, want = (f(gts, res) for f in (scorers.rouge_l_corpus,
                                                jax_scorers.rouge_l_corpus))
        elif scorer == "cider":
            got, want = (f(gts, res) for f in (scorers.cider_corpus,
                                                jax_scorers.cider_corpus))
        else:
            version = "1.0" if scorer == "meteor-1.0" else "1.5"
            got, want = (f(gts, res, version=version)
                         for f in (scorers.meteor_corpus,
                                   jax_scorers.meteor_corpus))
        assert got == want


def test_sentence_helpers():
    """``bleu4``, ``rouge_l`` and ``cider_d`` on the JAX test's cases and
    random ones."""
    rng = random.Random(4)
    hyps = ["a man is cooking", "totally different words here",
            "a dog runs fast", "kids play soccer"] + [
                _sentence(rng, 1) for _ in range(20)]
    refs = [["a man is cooking"], ["a man is cooking"], ["a dog runs fast"],
            ["kids play soccer"]] + [[_sentence(rng, 1)] for _ in range(20)]
    for h, r in zip(hyps, refs):
        assert metrics.bleu4(h, r) == jax_metrics.bleu4(h, r)
        assert metrics.rouge_l(h, r) == jax_metrics.rouge_l(h, r)
    assert metrics.cider_d(hyps, refs) == jax_metrics.cider_d(hyps, refs)


@pytest.mark.parametrize("protocol", ["2018", "2021"])
@pytest.mark.parametrize("seed", [5, 6])
def test_evaluate_dvc(protocol, seed):
    """Random predictions against random ground truth, as one file and as
    two (the best over files), and the JAX tests' overlap cases."""
    preds, gts = _dvc_sets(seed)
    _, other = _dvc_sets(seed + 100)
    assert metrics.evaluate_dvc(preds, gts, protocol=protocol) == \
        jax_metrics.evaluate_dvc(preds, gts, protocol=protocol)
    assert metrics.evaluate_dvc(preds, [gts, other], protocol=protocol,
                                max_proposals=3) == \
        jax_metrics.evaluate_dvc(preds, [gts, other], protocol=protocol,
                                 max_proposals=3)
    gt = {"v": [dict(timestamp=[0.0, 10.0], sentence="a man cooks dinner"),
                dict(timestamp=[8.0, 18.0], sentence="a man cooks dinner")]}
    mixed = {"v": [dict(timestamp=[0.0, 10.0],
                        sentence="a man cooks dinner"),
                   dict(timestamp=[100.0, 110.0], sentence="a man cooks")]}
    assert metrics.evaluate_dvc(mixed, gt, tious=(0.3,),
                                protocol=protocol) == \
        jax_metrics.evaluate_dvc(mixed, gt, tious=(0.3,), protocol=protocol)


@pytest.mark.parametrize("seed", [7, 8])
def test_soda_c(seed):
    preds, gts = _dvc_sets(seed)
    assert metrics.soda_c(preds, gts) == jax_metrics.soda_c(preds, gts)
    gt = {"v1": [dict(timestamp=[0, 10], sentence="a man cooks dinner"),
                 dict(timestamp=[20, 30], sentence="a dog runs fast")]}
    assert metrics.soda_c(gt, gt) == jax_metrics.soda_c(gt, gt)


@pytest.mark.parametrize("seed", [9, 10])
def test_evaluate_para(seed):
    """Paragraphs of the predictions in stored order against ground-truth
    paragraphs, as one file and as two."""
    preds, gts = _dvc_sets(seed)
    para = {v: ". ".join(e["sentence"] for e in g) for v, g in gts.items()}
    other = {v: p[::-1] for v, p in para.items()}
    assert metrics.evaluate_para(preds, para) == \
        jax_metrics.evaluate_para(preds, para)
    assert metrics.evaluate_para(preds, [para, other]) == \
        jax_metrics.evaluate_para(preds, [para, other])


@pytest.mark.parametrize("alpha,temperature", [(0.3, 2.0), (1.0, 1.0)])
def test_rerank_predictions(alpha, temperature):
    preds, _ = _dvc_sets(11)
    preds["v0"].append(dict(timestamp=[1.0, 2.0], sentence="",
                            score=0.5, proposal_score=0.5,
                            sentence_score=0.0))
    got = metrics.rerank_predictions(preds, alpha, temperature)
    want = jax_metrics.rerank_predictions(preds, alpha, temperature)
    assert got == want
    assert np.isfinite([e["score"] for v in got.values() for e in v]).all()
