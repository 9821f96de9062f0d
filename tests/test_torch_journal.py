"""The port's journal (fsdkr_tpu_torch/serving/journal.py) against the
JAX package's: CRC framing, segment rotation, the fsync policies,
torn-tail tolerance against mid-segment corruption, and the
journal_torn_write fault site, as tests/test_journal.py checks them;
segments written by either package are the other's byte for byte and
read by both.
"""

import json
import struct

import pytest

from fsdkr_tpu.serving import faults as j_faults
from fsdkr_tpu.serving import journal as j_journal

from fsdkr_tpu_torch.serving import faults, journal
from fsdkr_tpu_torch.telemetry import registry

PKGS = {"port": journal, "jax": j_journal}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    j_faults.reset()
    yield
    faults.reset()
    j_faults.reset()


def _recs(n, start=0):
    return [{"t": "broadcast", "sid": 1, "sender": start + i, "wire": "ab" * 50,
             "nested": {"b": [1, 2], "a": None}} for i in range(n)]


def _write(pkg, d, recs, **kw):
    j = PKGS[pkg].Journal(d, **{"sync": "off", **kw})
    for r in recs:
        j.append(r)
    j.close()
    return j


def _bytes(d):
    return [p.read_bytes() for p in journal.Journal.segment_paths(d)]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_roundtrip_rotation_and_reopen(tmp_path, writer, reader):
    recs = _recs(40)
    j = _write(writer, tmp_path / "j", recs, segment_bytes=4096)
    segs = journal.Journal.segment_paths(tmp_path / "j")
    assert len(segs) > 1 and j.stats()["segments"] == len(segs)
    assert all(s.read_bytes().startswith(journal.SEGMENT_MAGIC) for s in segs)
    assert PKGS[reader].read_records(tmp_path / "j") == recs
    # a new journal never appends to an old segment
    _write(reader, tmp_path / "j", [{"t": "x", "sid": 2}])
    assert len(journal.Journal.segment_paths(tmp_path / "j")) == len(segs) + 1
    assert PKGS[writer].read_records(tmp_path / "j") == recs + [{"t": "x", "sid": 2}]


def test_segments_are_the_jax_packages_byte_for_byte(tmp_path):
    recs = _recs(40)
    _write("port", tmp_path / "p", recs, segment_bytes=4096)
    _write("jax", tmp_path / "j", recs, segment_bytes=4096)
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "j")
    head = _bytes(tmp_path / "p")[0][:12]
    assert head == b"FSDKRWAL" + struct.pack("<I", 1)


def test_sync_policies(tmp_path):
    ja = journal.Journal(tmp_path / "a", sync="always")
    for r in _recs(3):
        ja.append(r)
    assert ja.fsyncs == 3
    ja.close()
    jb = journal.Journal(tmp_path / "b", sync="batch", batch_records=2)
    for r in _recs(3):
        jb.append(r)
    assert jb.fsyncs == 1  # one full batch; the tail syncs at close
    jb.close()
    assert jb.fsyncs == 2
    assert _write("port", tmp_path / "c", _recs(3)).fsyncs == 0
    with pytest.raises(ValueError, match="sync policy"):
        journal.Journal(tmp_path / "d", sync="fsync-plz")
    assert journal.Journal(tmp_path / "e").sync_policy == "batch"


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_torn_tail_dropped_and_counted(tmp_path, writer, reader):
    recs = _recs(5)
    _write(writer, tmp_path / "j", recs)
    seg = journal.Journal.segment_paths(tmp_path / "j")[0]
    data = seg.read_bytes()
    seg.write_bytes(data[:-20])  # inside the last record's payload
    torn = registry.counter("fsdkr_journal_torn_tails")
    t0 = torn.value()
    assert PKGS[reader].read_records(tmp_path / "j") == recs[:-1]
    if reader == "port":
        assert torn.value() == t0 + 1
    payload = json.dumps(recs[-1], sort_keys=True, separators=(",", ":")).encode()
    seg.write_bytes(data[: len(data) - (8 + len(payload)) + 3])  # inside its header
    assert PKGS[reader].read_records(tmp_path / "j") == recs[:-1]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_mid_segment_corruption_names_segment_and_offset(tmp_path, writer, reader):
    _write(writer, tmp_path / "j", _recs(5))
    seg = journal.Journal.segment_paths(tmp_path / "j")[0]
    data = bytearray(seg.read_bytes())
    data[len(data) // 2] ^= 0xFF
    seg.write_bytes(bytes(data))
    with pytest.raises(Exception) as ei:
        PKGS[reader].read_records(tmp_path / "j")
    assert type(ei.value).__name__ == "JournalCorruption"
    assert seg.name in str(ei.value) and ei.value.offset > 0
    seg.write_bytes(b"NOTAWAL!" + bytes(data)[8:])
    with pytest.raises(Exception, match="magic"):
        PKGS[reader].read_records(tmp_path / "j")


def test_corruption_message_is_the_jax_packages(tmp_path):
    _write("port", tmp_path / "j", _recs(5))
    seg = journal.Journal.segment_paths(tmp_path / "j")[0]
    data = bytearray(seg.read_bytes())
    data[len(data) // 2] ^= 0xFF
    seg.write_bytes(bytes(data))
    msgs = []
    for mod in PKGS.values():
        with pytest.raises(mod.JournalCorruption) as ei:
            mod.read_records(tmp_path / "j")
        msgs.append((str(ei.value), ei.value.segment, ei.value.offset))
    assert msgs[0] == msgs[1]


def test_missing_and_empty_directories_are_no_ops(tmp_path):
    assert journal.read_records(tmp_path / "nonexistent") == []
    (tmp_path / "empty").mkdir()
    assert journal.read_records(tmp_path / "empty") == []


def test_torn_write_fault_site(tmp_path):
    """journal_torn_write truncates the active segment mid-record: the
    record is lost, replay drops that segment's torn tail, and later
    appends land in a fresh segment — the same files in both packages."""
    inj = registry.counter("fsdkr_fault_injected", labelnames=("site",))
    i0 = inj.value(site="journal_torn_write")
    for pkg, fmod in (("port", faults), ("jax", j_faults)):
        j = PKGS[pkg].Journal(tmp_path / pkg, sync="off")
        j.append({"t": "a"})
        fmod.configure("seed=5,journal_torn_write=1.0,journal_torn_write_max=1")
        j.append({"t": "b"})
        fmod.reset()
        j.append({"t": "c"})
        j.close()
        assert len(journal.Journal.segment_paths(tmp_path / pkg)) == 2
        assert journal.read_records(tmp_path / pkg) == [{"t": "a"}, {"t": "c"}]
    assert _bytes(tmp_path / "jax") == _bytes(tmp_path / "port")
    assert inj.value(site="journal_torn_write") == i0 + 1


def test_registry_counters_and_closed_journal(tmp_path):
    r0 = registry.counter("fsdkr_journal_records").value()
    b0 = registry.counter("fsdkr_journal_bytes").value()
    s0 = registry.counter("fsdkr_journal_segments").value()
    j = _write("port", tmp_path / "j", _recs(4))
    assert registry.counter("fsdkr_journal_records").value() == r0 + 4
    assert registry.counter("fsdkr_journal_bytes").value() == b0 + j.bytes
    assert registry.counter("fsdkr_journal_segments").value() == s0 + 1
    j.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        j.append({"t": "b"})
