"""chip_smoke.py on a machine without a GPU, and its output comparison."""

import os
import shutil
import subprocess
import sys

import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    proc = _run(_REPO, os.path.join(_REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_fails_alone_outside_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), lone)
    proc = _run(str(tmp_path), str(lone))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _tree(root, files):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text.replace("ROOT", str(root)))


def test_compare_outputs_normalises_paths(tmp_path):
    files = {"c/c.vartigs": ">hap0 ROOT/c\nACGT\n",
             "contig_ploidy_info.tsv": "contig\tploidy\nc\t2\n",
             "cmd.log": "run ROOT"}
    a, b = tmp_path / "a", tmp_path / "bb"
    _tree(a, files)
    _tree(b, dict(files, **{"cmd.log": "another argv"}))
    assert chip_smoke.compare_outputs(str(a), str(b)) == []


def test_compare_outputs_reports_differences(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    _tree(a, {"c/c.haplosets": ">g0\nr1\nr2\n", "only_a.tsv": "x"})
    _tree(b, {"c/c.haplosets": ">g0\nr1\nr3\n", "only_b.tsv": "y"})
    diffs = chip_smoke.compare_outputs(str(a), str(b))
    assert any("only_a.tsv" in d for d in diffs)
    assert any("only_b.tsv" in d for d in diffs)
    assert any(d.startswith(os.path.join("c", "c.haplosets"))
               and "line 3" in d for d in diffs)


def test_compare_outputs_skips_rank_tsvs_when_asked(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    _tree(a, {"contig_ploidy_info.tsv": "h\n"})
    _tree(b, {"contig_ploidy_info.tsv": "h\n",
              "contig_ploidy_info.0.tsv": "h\n"})
    assert chip_smoke.compare_outputs(str(a), str(b)) != []
    assert chip_smoke.compare_outputs(
        str(a), str(b), skip=chip_smoke.RANK_TSV) == []
