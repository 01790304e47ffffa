"""``chip_smoke.write_json``: a child process that many threads end at once leaves its
counters file whole or absent, never empty or torn.

A sharded replica's rank exits from every request thread and from its SIGTERM handler
together when a rank of its world dies; the smoke reads the file each rank process wrote.
Each case runs a child in which 16 threads and the main thread write the same file with
``write_json`` and call ``os._exit`` at once, then parses what is on disk.
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = """
import os, sys, threading
sys.path.insert(0, {root!r})
import chip_smoke
out = sys.argv[1]
doc = {{"rank": 1, "launches": list(range(2000))}}
go = threading.Event()
def end(code):
    chip_smoke.write_json(out, dict(doc, rc=code))
    os._exit(code)
threads = [threading.Thread(target=lambda: (go.wait(), end(1))) for _ in range(16)]
for t in threads:
    t.start()
go.set()
end(75)
"""


@pytest.mark.parametrize("run", range(4))
def test_concurrent_exits_leave_the_file_whole(tmp_path, run):
    script = CHILD.format(root=str(ROOT))
    for i in range(8):
        out = tmp_path / f"replica0_{i}.json"
        proc = subprocess.run([sys.executable, "-c", script, str(out)], timeout=60)
        assert proc.returncode in (1, 75)
        doc = json.loads(out.read_text())
        assert doc["rc"] in (1, 75) and doc["launches"] == list(range(2000))
    # the temporary files match no reader's pattern
    assert sorted(p.name for p in tmp_path.glob("replica*_*.json")) == \
        [f"replica0_{i}.json" for i in range(8)]
