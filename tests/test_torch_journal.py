"""The port's request journal: torn-tail truncation, recovery corners,
rotation, and journals that cross between the packages.

A journal written by the JAX ``RequestJournal`` recovers in the port to
the same requests (prompt, sampling params, deadlines, tokens, key data,
state, finish reason, timestamps), and a journal the port writes
recovers in the JAX package to the same — the record grammar is one.
"""

import json
import os

import numpy as np
import pytest

from simple_distributed_machine_learning_tpu.serve import journal as jj
from simple_distributed_machine_learning_tpu.serve import request as jreq
from simple_distributed_machine_learning_tpu_torch.serve import journal as tj
from simple_distributed_machine_learning_tpu_torch.serve import request as treq
from simple_distributed_machine_learning_tpu_torch.serve.request import (
    DONE,
    QUEUED,
    SHED,
)

FIELDS = ("rid", "max_new_tokens", "temperature", "top_k", "top_p",
          "eos_id", "seed", "cls", "priority", "ttft_deadline_s",
          "deadline_s", "adapter", "state", "finish_reason", "tokens",
          "submit_time", "first_token_time", "done_time", "snap_reason")


def _norm(r) -> dict:
    out = {k: getattr(r, k) for k in FIELDS}
    out["prompt"] = [int(x) for x in np.asarray(r.prompt)]
    out["key_data"] = (None if r.key_data is None
                       else [int(x) for x in np.asarray(r.key_data)])
    out["draft_key_data"] = (None if r.draft_key_data is None else
                             [int(x) for x in np.asarray(r.draft_key_data)])
    return out


def _write(mod, req_mod, path, rotate_at=None):
    """One journal through ``mod``'s API: a budget finish, an EOS finish,
    a shed, an open sampled request with a draft key, an admission shed,
    a restart record, and (optionally) a rotation part-way."""
    j = mod.RequestJournal(path, sync=False)
    base = dict(temp=0.0, top_k=None, top_p=None, cls="interactive",
                prio=2, ttft_dl=0.075, dl=0.5)
    reqs = {}
    for rid, (prompt, max_new, eos) in enumerate(
            [([1, 2, 3], 2, None), ([4, 5], 6, 9), ([6], 4, None)]):
        j.log_submit(rid=rid, prompt=prompt, max_new=max_new, eos=eos,
                     seed=100 + rid, t=0.001 * (rid + 1), tick=rid, **base)
        reqs[rid] = req_mod.Request(rid=rid, prompt=np.asarray(prompt),
                                    max_new_tokens=max_new, eos_id=eos)
    j.log_submit(rid=3, prompt=[7, 8, 9, 10], max_new=5, temp=0.8, top_k=8,
                 top_p=None, eos=None, seed=103, cls="batch", prio=0,
                 ttft_dl=None, dl=1.5, t=0.004)
    reqs[3] = req_mod.Request(rid=3, prompt=np.asarray([7, 8, 9, 10]),
                              max_new_tokens=5)
    for i, (rid, tok) in enumerate([(0, 5), (1, 3), (2, 11), (3, 12),
                                    (0, 6), (1, 9), (3, 2)]):
        r = reqs[rid]
        r.tokens.append(tok)
        r.key_data = np.asarray([rid, 1000 + i], np.uint32)
        r.draft_key_data = (np.asarray([7, i], np.uint32) if rid == 3
                            else None)
        if len(r.tokens) == 1:
            r.first_token_time = 0.01 + 0.001 * i
        j.log_token(r, tok, tick=10 + i)
        if rotate_at == i:
            j.rotate(tick=10 + i)
    j.log_done(rid=0, reason="length", t=0.05, tick=20)
    j.log_shed(rid=2, reason="deadline", t=0.06, tick=21)
    j.log_restart(1, False, "EngineCrash", tick=22)
    j.log_submit(rid=4, prompt=[3, 3], max_new=2, eos=None, seed=104,
                 t=0.07, **base)
    j.log_shed(rid=4, reason="backpressure", t=0.07)
    j.close()


def _recover(mod, path):
    return {rid: _norm(r) for rid, r in
            mod.recover_state(mod.read_journal(path)[0]).items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("rotate_at", [None, 3])
def test_journals_recover_identically_across_packages(tmp_path, writer,
                                                      rotate_at):
    path = str(tmp_path / "j.jsonl")
    if writer == "jax":
        _write(jj, jreq, path, rotate_at)
    else:
        _write(tj, treq, path, rotate_at)
    ours, ref = _recover(tj, path), _recover(jj, path)
    assert ours == ref
    assert sorted(ours) == [0, 1, 2, 3, 4]
    assert ours[0]["state"] == DONE and ours[0]["tokens"] == [5, 6]
    assert ours[1]["state"] == DONE and ours[1]["finish_reason"] == "eos"
    assert ours[2]["state"] == SHED and ours[2]["tokens"] == [11]
    assert ours[3]["state"] == QUEUED and ours[3]["tokens"] == [12, 2]
    assert ours[3]["key_data"] == [3, 1006]
    assert ours[3]["draft_key_data"] == [7, 6]
    assert ours[4]["finish_reason"] == "backpressure"


def test_both_packages_write_the_same_bytes(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _write(jj, jreq, a, rotate_at=4)
    _write(tj, treq, b, rotate_at=4)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_truncated_tail_recovers_longest_valid_prefix(tmp_path):
    """A mid-write crash tears at most the tail: recovery keeps every
    valid line, and reopening truncates so later appends land cleanly."""
    path = str(tmp_path / "j.jsonl")
    j = tj.RequestJournal(path, sync=False)
    j.log_submit(rid=0, prompt=[1, 2, 3], max_new=4, temp=0.0, top_k=None,
                 top_p=None, eos=None, seed=0, cls=None, prio=0,
                 ttft_dl=None, dl=None, t=1.0)
    j.append({"ev": "tok", "rid": 0, "tok": 7, "kd": [1, 2], "dkd": None})
    j.close()
    with open(path, "ab") as f:           # the torn mid-write tail
        f.write(b'{"ev":"tok","rid":0,"to')
    events, valid = tj.read_journal(path)
    assert [e["ev"] for e in events] == ["submit", "tok"]
    assert valid < os.path.getsize(path)
    j2 = tj.RequestJournal(path, sync=False)
    assert os.path.getsize(path) == valid == j2.bytes
    assert [e["ev"] for e in j2.recovered_events] == ["submit", "tok"]
    j2.log_done(rid=0, reason="length", t=2.0)
    j2.close()
    assert [e["ev"] for e in tj.read_journal(path)[0]] == [
        "submit", "tok", "done"]
    # everything after the first invalid line is discarded
    with open(path, "r+b") as f:
        raw = f.read()
        f.seek(0)
        f.write(raw.replace(b'"ev":"tok"', b'"ev:"tok"', 1))
    assert [e["ev"] for e in tj.read_journal(path)[0]] == ["submit"]
    assert tj.read_journal(str(tmp_path / "absent.jsonl")) == ([], 0)


def test_finished_but_unacked_is_promoted_to_done(tmp_path):
    """The 'last token journaled, done record lost' corner, both finish
    kinds: DONE with the right reason and the journaled stream."""
    base = dict(prompt=[1, 2], temp=0.0, top_k=None, top_p=None, seed=0,
                cls=None, prio=0, ttft_dl=None, dl=None, t=0.0)
    path = str(tmp_path / "j.jsonl")
    j = tj.RequestJournal(path, sync=False)
    j.log_submit(rid=0, max_new=2, eos=None, **base)       # budget finish
    j.append({"ev": "tok", "rid": 0, "tok": 5, "kd": [1, 1], "dkd": None})
    j.append({"ev": "tok", "rid": 0, "tok": 6, "kd": [2, 2], "dkd": None})
    j.log_submit(rid=1, max_new=8, eos=9, **base)          # EOS finish
    j.append({"ev": "tok", "rid": 1, "tok": 9, "kd": [3, 3], "dkd": None})
    j.log_submit(rid=2, max_new=8, eos=None, **base)       # still open
    j.append({"ev": "tok", "rid": 2, "tok": 4, "kd": [4, 4], "dkd": None})
    j.close()
    snap = tj.recover_state(tj.read_journal(path)[0])
    assert snap[0].state == DONE and snap[0].finish_reason == "length"
    assert snap[0].tokens == [5, 6]
    assert snap[1].state == DONE and snap[1].finish_reason == "eos"
    assert snap[2].state == QUEUED and snap[2].tokens == [4]
    assert list(snap[2].key_data) == [4, 4]


def test_rotate_compacts_and_recovers_identically(tmp_path):
    """Rotation rewrites the journal as one snap per rid (restart records
    dropped) and changes the replay cost, never the recovered state;
    appends after it fold on top of the snaps."""
    path = str(tmp_path / "j.jsonl")
    _write(tj, treq, path)
    before = _recover(tj, path)
    j = tj.RequestJournal(path, sync=False)
    reclaimed = j.rotate(tick=30)
    assert reclaimed > 0 and j.bytes == os.path.getsize(path)
    events = [json.loads(line) for line in open(path)]
    assert [e["ev"] for e in events] == ["snap"] * 5
    assert [e["rid"] for e in events] == [0, 1, 2, 3, 4]
    assert _recover(tj, path) == before
    r3 = j.recovered_state()[3]
    r3.tokens.append(4)
    r3.key_data = np.asarray([3, 2000], np.uint32)
    j.log_token(r3, 4)
    j.close()
    after = _recover(tj, path)
    assert after[3]["tokens"] == [12, 2, 4]
    assert after[3]["key_data"] == [3, 2000]
    assert after[3]["state"] == QUEUED        # 3 of 5: still open


def test_tail_and_sync_close(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = tj.RequestJournal(path)               # fsync per record (default)
    assert j.sync
    for rid in range(3):
        j.log_shed(rid=rid, reason="class", t=0.0)
    assert [e["rid"] for e in j.tail(2)] == [1, 2]
    j.close()
    j.close()                                 # idempotent
