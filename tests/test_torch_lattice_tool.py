"""The port's ``bin/lattice_tool`` and ``bin/compare_posteriors`` CLIs against
the JAX package's on the CPU.

The lattices are decoded by the port's host decoder on a homophone system
(tests/test_lattice_tools.py's hand-made lattice and
tests/test_arpa.py::test_lattice_lmrescore_fixes_homophones's setup, at
small size): a unigram-LM HCLG whose lattices an order-3 LM rescores. Both
CLIs read the same archives with the same argv; every file they write
(best paths, N-best lists, rescored and pruned lattices, CTMs) must be equal
byte for byte, and so must what they print (WER lines, best paths on
standard output), log lines' timestamps aside. ``compare_posteriors`` must
return the JAX CLI's exit codes and print its lines.
"""

import re

import numpy as np
import pytest

from pykaldi2_tpu.bin.compare_posteriors import main as jax_compare
from pykaldi2_tpu.bin.lattice_tool import main as jax_lattice_tool

from pykaldi2_tpu_torch.bin.compare_posteriors import main as port_compare
from pykaldi2_tpu_torch.bin.lattice_tool import main as port_lattice_tool
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
from pykaldi2_tpu_torch.decode.lattice import lattice_word_fst, write_lattices_text
from pykaldi2_tpu_torch.decode.lattice_ark import write_lattice_ark
from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel
from pykaldi2_tpu_torch.graph.arpa import train_arpa, write_arpa
from pykaldi2_tpu_torch.graph.compile import make_word_decode_graph
from pykaldi2_tpu_torch.graph.fst import Fst

_LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+ \[")


def _printed(out: str) -> list:
    """Standard output without the timestamped log lines."""
    return [line for line in out.splitlines() if not _LOG_LINE.match(line)]


def _word_fst(paths):
    """Acceptor with the given [(words, weight)] paths
    (tests/test_lattice_tools.py:_word_fst)."""
    f = Fst()
    root = f.add_state()
    f.set_start(root)
    for words, w in paths:
        cur = root
        for i, lab in enumerate(words):
            nxt = f.add_state()
            f.add_arc(cur, lab, lab, w if i == 0 else 0.0, nxt)
            cur = nxt
        f.set_final(cur, 0.0)
    return f


@pytest.fixture(scope="module")
def lattices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lattice_tool")
    rng = np.random.RandomState(13)
    phones = list(range(1, 9))
    tm = TransitionModel(HmmTopology.one_state(phones))
    seen, lexicon, vocab = set(), {}, []

    def fresh_pron():
        while True:
            pron = tuple(int(rng.choice(phones)) for _ in range(rng.randint(2, 5)))
            if pron not in seen:
                seen.add(pron)
                return list(pron)

    for i in range(4):          # homophone pairs a<i>/b<i>
        pron = fresh_pron()
        for prefix in "ab":
            vocab.append(f"{prefix}{i}")
            lexicon[f"{prefix}{i}"] = [pron]
    for ctx in ("ca", "cb"):
        vocab.append(ctx)
        lexicon[ctx] = [fresh_pron()]
    word_ids = {w: i + 1 for i, w in enumerate(vocab)}
    sents = [["ca", f"a{rng.randint(4)}"] if rng.rand() < 0.5 else ["cb", f"b{rng.randint(4)}"]
             for _ in range(200)]
    uni, tri = str(tmp / "uni.arpa"), str(tmp / "tri.arpa")
    write_arpa(train_arpa(sents, order=1), uni)
    write_arpa(train_arpa(sents, order=3), tri)
    dec = LatticeDecoder(make_word_decode_graph(tm, lexicon, word_ids, train_arpa(sents, 1)),
                         beam=20.0, max_active=7000, lattice_beam=12.0)
    lats, refs = {}, []
    for k in range(6):
        i = rng.randint(4)
        ref = ["ca", f"a{i}"] if k % 2 == 0 else ["cb", f"b{i}"]
        pdfs = [tm.pdf_for(ph, 0) for w in ref for ph in lexicon[w][0] for _ in range(3)]
        obs = rng.randn(len(pdfs), tm.num_pdfs).astype(np.float32) * 0.1
        obs[np.arange(len(pdfs)), pdfs] += 6.0
        lat, frames, _ = dec.decode_lattice(obs, with_frames=True)
        lats[f"utt{k}"] = lattice_word_fst(lat, loglikes=obs, frames=frames)
        refs.append(f"utt{k} " + " ".join(ref) + "\n")
    files = dict(uni=uni, tri=tri, txt=str(tmp / "lat.txt"), ark=str(tmp / "lat.ark"),
                 small=str(tmp / "small.txt"), words=str(tmp / "words.txt"),
                 ref=str(tmp / "ref.txt"), small_ref=str(tmp / "small_ref.txt"),
                 small_words=str(tmp / "small_words.txt"))
    write_lattices_text(files["txt"], lats)
    write_lattice_ark(files["ark"], lats)
    write_lattices_text(files["small"], {"u1": _word_fst([((1, 2), -1.0), ((3,), -0.25)])})
    with open(files["words"], "w") as f:
        f.write("<eps> 0\n" + "".join(f"{w} {i}\n" for w, i in word_ids.items()))
    with open(files["ref"], "w") as f:
        f.write("".join(refs))
    with open(files["small_words"], "w") as f:
        f.write("<eps> 0\nalpha 1\nbeta 2\ngamma 3\n")
    with open(files["small_ref"], "w") as f:
        f.write("u1 alpha beta\n")
    return tmp, files


CASES = {
    # tests/test_lattice_tools.py::test_lattice_tool_cli
    "small": ["-lattices", "{small}", "-words", "{small_words}", "-best_path", "@hyp.txt",
              "-nbest", "5", "-nbest_out", "@nb.txt", "-ref", "{small_ref}"],
    "best_nbest_ref": ["-lattices", "{txt}", "-words", "{words}", "-best_path", "@hyp.txt",
                       "-nbest", "10", "-nbest_out", "@nb.txt", "-ref", "{ref}"],
    "binary_stdout": ["-lattices", "{ark}", "-words", "{words}", "-best_path", "-",
                      "-nbest", "3", "-ref", "{ref}"],
    "rescore": ["-lattices", "{txt}", "-words", "{words}", "-arpa_old", "{uni}", "-arpa_new",
                "{tri}", "-rescored_out", "@resc.txt", "-best_path", "@hyp.txt", "-ref",
                "{ref}"],
    "rescore_ark_scale": ["-lattices", "{ark}", "-words", "{words}", "-arpa_new", "{tri}",
                          "-lm_scale", "0.5", "-rescored_out", "@resc.ark", "-nbest", "4",
                          "-nbest_out", "@nb.txt"],
    "prune_mbr_ctm": ["-lattices", "{txt}", "-words", "{words}", "-prune_beam", "4.0",
                      "-pruned_out", "@pruned.ark", "-ctm_out", "@out.ctm", "-best_path",
                      "@hyp.txt", "-ref", "{ref}"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lattice_tool_cli_matches_jax_cli(lattices, case, capsys):
    tmp, files = lattices
    outs = {}
    for side, fn in (("jax", jax_lattice_tool), ("port", port_lattice_tool)):
        d = tmp / f"{case}_{side}"
        d.mkdir()
        argv = [str(d / a[1:]) if a.startswith("@") else a.format(**files)
                for a in CASES[case]]
        assert fn(argv) == 0
        outs[side] = (d, capsys.readouterr().out)
    (dj, out_j), (dp, out_p) = outs["jax"], outs["port"]
    assert _printed(out_p) == _printed(out_j)
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dp.iterdir())
    assert names or _printed(out_j)
    for n in names:
        assert (dp / n).read_bytes() == (dj / n).read_bytes(), n
    if case == "small":
        assert (dp / "hyp.txt").read_text().strip() == "u1 gamma"
        assert len((dp / "nb.txt").read_text().strip().splitlines()) == 2


@pytest.fixture(scope="module")
def arks(tmp_path_factory):
    """tests/test_cli_tools.py::test_compare_posteriors_cli's arks, plus one
    with no common utterance and one with a shape mismatch."""
    tmp = tmp_path_factory.mktemp("compare_posteriors")
    rng = np.random.RandomState(30)
    mats = {f"u{i}": rng.randn(20 + i, 6).astype(np.float32) for i in range(3)}
    paths = {}
    for name, noise in [("a", 0.0), ("b", 1e-5), ("c", 0.5)]:
        paths[name] = str(tmp / f"{name}.ark")
        with kaldi_io.ArkWriter(paths[name], kind="mat") as w:
            for k, m in mats.items():
                w.write(k, m + rng.randn(*m.shape).astype(np.float32) * noise)
    paths["other"] = str(tmp / "other.ark")
    with kaldi_io.ArkWriter(paths["other"], kind="mat") as w:
        w.write("x0", mats["u0"])
    paths["short"] = str(tmp / "short.ark")
    with kaldi_io.ArkWriter(paths["short"], kind="mat") as w:
        for k, m in mats.items():
            w.write(k, m[:-5])
    return paths


@pytest.mark.parametrize("pair,extra,rc", [
    (("a", "b"), ["-atol", "1e-3"], 0),        # within tolerance
    (("a", "c"), ["-atol", "1e-3"], 1),        # grossly different
    (("a", "other"), [], 2),                   # no common utterance
    (("a", "short"), [], 1),                   # 5 frames short: beyond -frames_tol 2
    (("a", "short"), ["-frames_tol", "5"], 0),
    (("a", "b"), ["-atol", "1e-9", "-min_corr", "0.5"], 1),
])
def test_compare_posteriors_cli_matches_jax_cli(arks, pair, extra, rc, capsys):
    argv = [arks[pair[0]], arks[pair[1]]] + extra
    assert jax_compare(argv) == rc
    out_j = capsys.readouterr()
    assert port_compare(argv) == rc
    out_p = capsys.readouterr()
    assert _printed(out_p.out) == _printed(out_j.out)
    assert out_p.err == out_j.err
