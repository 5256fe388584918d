"""The harness finds cells, configurations, traffic mixes and per-layer
metrics by their files: in a copy of the benchmark's folder, new files
alone add each, with no file edited."""

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _listing(root):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--list"],
                         capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _listing(root)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "pillarnet34_nusc.json").read_text())
    (b / "configs" / "pillarnet34_nusc_wide.json").write_text(
        json.dumps(cfg))
    (b / "traffic" / "lidar_stream_20hz.json").write_text(json.dumps(
        dict(json.loads((b / "traffic" / "lidar_stream.json").read_text()),
             rate_hz=20.0)))
    (b / "workloads" / "wide_stream.json").write_text(json.dumps(
        {"config": "pillarnet34_nusc_wide", "traffic": "lidar_stream_20hz",
         "chips": 1, "limits": {"det_gap": 1.0, "kept_mismatch": 1.0}}))
    (b / "metrics" / "frames_seen.stream.py").write_text(
        'UNIT = "frames"\n\n\ndef read(ctx):\n'
        '    return len(ctx.host_issue_ms) if ctx.tag == "stream" '
        'else None\n')
    after = _listing(root)
    assert set(after["configs"]) - set(before["configs"]) == {
        "pillarnet34_nusc_wide"}
    assert set(after["traffic"]) - set(before["traffic"]) == {
        "lidar_stream_20hz"}
    assert after["workloads"]["wide_stream"] == {
        "config": "pillarnet34_nusc_wide", "traffic": "lidar_stream_20hz",
        "chips": 1}
    assert set(after["metrics"]) - set(before["metrics"]) == {
        "frames_seen.stream"}
    for name in before["workloads"]:
        assert after["workloads"][name] == before["workloads"][name]
