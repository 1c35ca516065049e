"""CLI smoke tests: flag parsing, auto-estimation path, end-to-end run
through `python -m floria_tpu.cli`."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_end_to_end(small_sim, tmp_path):
    cfg, truth, sim = small_sim
    out = str(tmp_path / "cli_out")
    r = subprocess.run(
        [sys.executable, "-m", "floria_tpu.cli",
         "-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
         "-r", sim + "/sim.fa", "-o", out,
         "-e", "0.02", "-l", "4000", "--snp-count-filter", "10",
         "-p", "3", "-t", "4"],
        capture_output=True, text=True, env=_env(), cwd=REPO,
        timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    cdir = os.path.join(out, cfg.contig_name)
    assert os.path.exists(os.path.join(cdir,
                                       f"{cfg.contig_name}.vartigs"))
    assert os.path.exists(os.path.join(out, "cmd.log"))
    # Existing dir without --overwrite is refused (parse_cmd_line.rs:116).
    r2 = subprocess.run(
        [sys.executable, "-m", "floria_tpu.cli",
         "-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
         "-r", sim + "/sim.fa", "-o", out, "-e", "0.02", "-l", "4000"],
        capture_output=True, text=True, env=_env(), cwd=REPO,
        timeout=120)
    assert r2.returncode != 0


def test_cli_auto_estimation(small_sim, tmp_path):
    """Without -e/-l the CLI estimates both from the BAM pileup."""
    cfg, truth, sim = small_sim
    out = str(tmp_path / "cli_auto")
    r = subprocess.run(
        [sys.executable, "-m", "floria_tpu.cli",
         "-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
         "-r", sim + "/sim.fa", "-o", out,
         "--snp-count-filter", "10", "-G", cfg.contig_name],
        capture_output=True, text=True, env=_env(), cwd=REPO,
        timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Estimated" in r.stderr or "Estimated" in r.stdout
