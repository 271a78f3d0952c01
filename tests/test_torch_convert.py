"""antidote_tpu_torch.oplog.convert.data_dir_from_jax: a data directory
that the JAX package's AntidoteTPU wrote and closed, converted, opens in
the port's AntidoteGPU (on the CPU) with the same history: every key
reads the same value, after a checkpoint truncated the log, with a
transaction pending across the cut, and with monolithic and segmented
checkpoints.  The port's half runs in a subprocess that must never
import antidote_tpu or jax (a pickle naming the JAX package's classes
would import it)."""

import json
import os
import subprocess
import sys

import pytest

from antidote_tpu.api import AntidoteTPU
from antidote_tpu.clocks import VC as JVC
from antidote_tpu.config import Config as JConfig
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch.oplog.convert import data_dir_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_partitions=2, ckpt_retain_ops=0)
OBJECTS = ([(f"c{i}", "counter_pn") for i in range(6)]
           + [(f"s{i}", "set_aw") for i in range(4)]
           + [("r0", "register_mv"), ("g0", "map_go"), ("t0", "rga"),
              ("f0", "counter_fat")])

PORT_SIDE = """
import json, sys
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.oplog.convert import data_dir_from_jax
src, dst, cfg, objects = json.loads(sys.argv[1])
files = data_dir_from_jax(src, dst)
db = AntidoteGPU(config=Config(**cfg), data_dir=dst, device="cpu")
vals, _ = db.read_objects_static(None, [tuple(o) for o in objects])
suffix = [pm.log.suffix_start for pm in db.node.partitions]
base = [pm.log.log.truncated_base for pm in db.node.partitions]
db.close()
bad = [m for m in sys.modules if m in ("jax", "antidote_tpu")
       or m.startswith(("jax.", "antidote_tpu."))]
print(json.dumps([files, [repr(v) for v in vals], suffix, base, bad]))
"""


def _tape(db, n, seed):
    clock = None
    for i in range(seed, seed + n):
        clock = db.update_objects_static(clock, [
            ((f"c{i % 6}", "counter_pn"), "increment", i % 5 + 1),
            ((f"s{i % 4}", "set_aw"), "add" if i % 3 else "remove",
             f"e{i % 7}".encode()),
            (("r0", "register_mv"), "assign", f"v{i}".encode()),
            (("g0", "map_go"), "update",
             ((f"m{i % 3}".encode(), "counter_pn"), ("increment", 1))),
            (("f0", "counter_fat"), "increment", 2),
        ])
        clock = db.update_objects_static(
            clock, [(("t0", "rga"), "add_right", (i % 3, f"x{i}"))])
    return clock


@pytest.mark.parametrize("ckpt", ["none", "monolithic", "segmented"])
def test_converted_dir_reads_the_same(tmp_path, ckpt, monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    cfg = dict(CFG, ckpt=ckpt != "none",
               ckpt_segmented=ckpt == "segmented")
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    db = AntidoteTPU(dc_id="dc1", config=JConfig(**cfg), data_dir=src)
    _tape(db, 30, 0)
    pm = db.node.partitions[0]
    txid = ("dc1", 99_999)
    if ckpt != "none":
        # a txn whose update precedes the cut and whose commit follows
        pm.stage_update(txid, "c0", "counter_pn", 100)
        for p in db.node.partitions:
            assert p.checkpoint_now() is not None
        assert any(p.log.log.truncated_base > 0
                   for p in db.node.partitions)
        assert pm.log.ckpt_doc["pending"]
        pm.commit(txid, db.node.clock.now_us(),
                  JVC({"dc1": db.node.clock.now_us()}), certified=False)
    _tape(db, 12, 100)
    want, _ = db.read_objects_static(None, OBJECTS)
    db.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", PORT_SIDE,
         json.dumps([src, dst, cfg, OBJECTS])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    files, got, suffix, base, bad = json.loads(out.stdout.splitlines()[-1])
    assert bad == []
    assert files == sorted(os.listdir(src))
    assert got == [repr(v) for v in want]
    if ckpt != "none":
        assert any(suffix) and any(base)


def test_converter_refuses_what_it_does_not_know(tmp_path, monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    src = tmp_path / "jax"
    db = AntidoteTPU(dc_id="dc1", config=JConfig(**CFG), data_dir=str(src))
    _tape(db, 5, 0)
    for p in db.node.partitions:
        p.checkpoint_now()
    db.close()
    names = sorted(os.listdir(src))
    seg = next(n for n in names if ".seg-" in n)
    ckpt = next(n for n in names if n.endswith(".ckpt"))
    cases = {
        "unknown": lambda d: (d / "stray.txt").write_bytes(b"x"),
        "unlisted segment": lambda d: (d / (seg[:-8] + "99999999"))
        .write_bytes((d / seg).read_bytes()),
        "torn checkpoint": lambda d: (d / ckpt).write_bytes(
            (d / ckpt).read_bytes()[:-3]),
        "checkpoint without its log": lambda d: os.remove(
            d / ckpt[:-len(".ckpt")]),
    }
    for i, (what, spoil) in enumerate(cases.items()):
        bad = tmp_path / f"bad{i}"
        bad.mkdir()
        for n in names:
            (bad / n).write_bytes((src / n).read_bytes())
        spoil(bad)
        with pytest.raises(ValueError):
            data_dir_from_jax(str(bad), str(tmp_path / f"out{i}"))
    (tmp_path / "full").mkdir()
    (tmp_path / "full" / "x").write_bytes(b"")
    with pytest.raises(ValueError, match="not empty"):
        data_dir_from_jax(str(src), str(tmp_path / "full"))
    assert sorted(os.listdir(src)) == names     # the source is untouched
