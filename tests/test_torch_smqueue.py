"""The port's `smqueue` (the RFC 3428 store-and-forward SMS daemon): the
counterpart of tests/test_smqueue.py's 20 tests on
`openbts_ttsou_tpu_torch.smqueue`, then its tables and a message walk
against the JAX package's, and its command-line entry point."""

import os
import time

import pytest

from openbts_ttsou_tpu_torch.sip.message import SIPMessage, make_request
from openbts_ttsou_tpu_torch.smqueue import SMq, ShortMsgState
from openbts_ttsou_tpu_torch.smqueue.queue import (
    INITIAL_STATE,
    STATE_TIMEOUTS,
    sm_state_name,
)


@pytest.fixture
def smq():
    sent = []
    registry = {"2001": "2001", "2002": "2002"}
    q = SMq(send=lambda to, req: sent.append((to, req)),
            resolve=lambda user: registry.get(user))
    q._sent = sent
    q._registry = registry
    return q


def drive(smq, now, n=4):
    """Advance the queue n state transitions (one per call, like the
    reference's one-action-per-pop main_loop)."""
    for _ in range(n):
        smq.process_queue(now)


def test_state_set_matches_reference():
    # the 16 states of smqueue.h:59-83
    assert len(ShortMsgState) == 16
    assert INITIAL_STATE == ShortMsgState.RequestFromAddressLookup
    assert sm_state_name(ShortMsgState.DeleteMeState) == "DeleteMeState"
    # every ASKED/AWAITING state has a timeout row falling back to a
    # REQUEST/RegisterHandset state
    for st, (timeout, nxt) in STATE_TIMEOUTS.items():
        assert timeout > 0
        assert nxt.name.startswith(("Request", "RegisterHandset"))


def test_timeout_table_matches_reference():
    """Spot-audit of the full 16×16 transition-timeout table against
    the reference values (smqueue.cpp:46-120; NT=6000, RT=600)."""
    from openbts_ttsou_tpu_torch.smqueue.queue import NT, RT, TIMEOUTS

    S = ShortMsgState
    assert NT == 6000 and RT == 600
    # RequestFromAddressLookup row: →AF 10, →WR 1, →RH 0
    assert TIMEOUTS[S.RequestFromAddressLookup][
        S.AskedForFromAddressLookup] == 10
    assert TIMEOUTS[S.RequestFromAddressLookup][
        S.AwaitingRegisterHandset] == 1
    assert TIMEOUTS[S.RequestFromAddressLookup][S.RegisterHandset] == 0
    # AskedForFromAddressLookup: retry RF after 60 s
    assert TIMEOUTS[S.AskedForFromAddressLookup][
        S.RequestFromAddressLookup] == 60
    # delivery cluster: RM→AM 15, RM→{WM,RM,RS} 75; AM→WM 60, AM→RM 10
    assert TIMEOUTS[S.RequestMsgDelivery][S.AskedForMsgDelivery] == 15
    assert TIMEOUTS[S.RequestMsgDelivery][S.AwaitingTryMsgDelivery] == 75
    assert TIMEOUTS[S.RequestMsgDelivery][S.RequestMsgDelivery] == 75
    assert TIMEOUTS[S.RequestMsgDelivery][S.RequestDestinationSipUrl] == 75
    assert TIMEOUTS[S.AskedForMsgDelivery][S.AwaitingTryMsgDelivery] == 60
    assert TIMEOUTS[S.AskedForMsgDelivery][S.RequestMsgDelivery] == 10
    # registration cluster: RH→AR 2, AR→AR 10, WR→RH 0
    assert TIMEOUTS[S.RegisterHandset][S.AskedToRegisterHandset] == 2
    assert TIMEOUTS[S.AskedToRegisterHandset][
        S.AskedToRegisterHandset] == 10
    assert TIMEOUTS[S.AwaitingRegisterHandset][S.RegisterHandset] == 0
    # DeleteMe row is all-zero; error retries go through RT
    assert all(v == 0 for v in TIMEOUTS[S.DeleteMeState])
    assert TIMEOUTS[S.AwaitingTryDestinationImsi][
        S.RequestFromAddressLookup] == RT


def test_submit_and_deliver(smq):
    m = smq.submit("1001", "2001", "hello")
    assert m.state == INITIAL_STATE
    now = time.monotonic() + 0.01
    assert smq.queue_size() == 1
    drive(smq, now)  # from-lookup → imsi → sipurl → send
    assert len(smq._sent) == 1
    to, rendered = smq._sent[0]
    assert to == "2001"
    req = SIPMessage.parse(rendered.encode())
    assert req.method == "MESSAGE" and req.body == "hello"
    assert m.state == ShortMsgState.AskedForMsgDelivery
    assert m.dest_imsi == "2001"
    # destination acks
    smq.handle_delivery_response(m.call_id, 200)
    assert len(smq.delivered) == 1
    assert m.state == ShortMsgState.DeleteMeState
    smq.process_queue(time.monotonic() + 0.01)
    assert smq.queue_size() == 0


def test_unknown_destination_retries_then_fails(smq):
    m = smq.submit("1001", "9999", "void")
    now = time.monotonic() + 0.01
    step = STATE_TIMEOUTS[ShortMsgState.AwaitingTryDestinationImsi][0]
    for i in range(smq.MAX_RETRIES + 2):
        smq.process_queue(now + i * (step + 1))
    assert m.state == ShortMsgState.DeleteMeState
    assert len(smq.failed) == 1


def test_delivery_timeout_retries(smq):
    m = smq.submit("1001", "2002", "slow")
    now = time.monotonic() + 0.01
    drive(smq, now)
    assert len(smq._sent) == 1
    # no ack → timeout → falls back to RequestMsgDelivery, which the
    # reference re-arms with a 10 s retry delay (TIMEOUTS[AM][RM] = 10,
    # smqueue.cpp:83-84) → resend only after that delay passes
    timeout = STATE_TIMEOUTS[ShortMsgState.AskedForMsgDelivery][0]
    drive(smq, now + timeout + 1)
    assert m.state == ShortMsgState.RequestMsgDelivery
    assert len(smq._sent) == 1  # retry delay still pending
    drive(smq, now + timeout + 1 + 10 + 1, n=2)
    assert len(smq._sent) == 2
    assert m.retries == 1
    assert m.state == ShortMsgState.AskedForMsgDelivery


def test_failure_response_triggers_retry(smq):
    m = smq.submit("1001", "2001", "x")
    now = time.monotonic() + 0.01
    drive(smq, now)
    smq.handle_delivery_response(m.call_id, 480)
    assert m.state == ShortMsgState.RequestMsgDelivery


def test_handset_registration_flow():
    sent = []
    registry = {}
    reg_calls = []
    q = SMq(send=lambda to, req: sent.append((to, req)),
            resolve=lambda user: registry.get(user),
            register_handset=lambda user: reg_calls.append(user) or True)
    m = q.submit("1001", "3001", "welcome")
    now = time.monotonic() + 0.01
    # from-lookup → imsi lookup fails → RegisterHandset → asked
    q.process_queue(now)
    q.process_queue(now)
    q.process_queue(now)
    assert m.state == ShortMsgState.AskedToRegisterHandset
    assert reg_calls == ["3001"]
    # registration completes; destination becomes resolvable
    registry["3001"] = "3001"
    q.handle_registration_complete("3001", True)
    assert m.state == ShortMsgState.RequestDestinationImsi
    drive(q, time.monotonic() + 0.01)
    assert len(sent) == 1 and sent[0][0] == "3001"


def test_registration_timeout_falls_back():
    q = SMq(send=lambda to, req: None, resolve=lambda u: None,
            register_handset=lambda u: True)
    m = q.submit("1001", "3001", "hi")
    now = time.monotonic() + 0.01
    drive(q, now, n=3)
    assert m.state == ShortMsgState.AskedToRegisterHandset
    timeout = STATE_TIMEOUTS[ShortMsgState.AskedToRegisterHandset][0]
    q.process_queue(now + timeout + 1)
    assert m.state == ShortMsgState.RegisterHandset


def test_shortcode_handler(smq):
    m = smq.submit("1001", "411", "who am i")
    assert m.state == ShortMsgState.DeleteMeState
    # the status reply was queued back toward the sender
    # (shortcode_four_one_one, smcommands.cpp:80-151: queue counts,
    # sender, phonenum, time, echoed text)
    assert smq.queue_size() == 1
    assert smq._heap[0].to == "1001"
    body = smq._heap[0].body
    assert "queued" in body and "1001" in body and "'who am i'" in body


def test_sip_ingress(smq):
    req = make_request("MESSAGE", "2001", "1001", "127.0.0.1", 5063,
                      "127.0.0.1", 5062, body="via sip",
                      content_type="text/plain")
    resp = smq.handle_sip_message(SIPMessage.parse(req.render()))
    assert resp.status == 200
    assert smq.queue_size() == 1


# -- the ported shortcode plugin set (smcommands.cpp:360-368) ----------

@pytest.fixture
def smq_hlr():
    from openbts_ttsou_tpu_torch.control.hlr import LocalHLR

    sent = []
    hlr = LocalHLR()
    hlr.add_user("901550000000001", "5551234")
    q = SMq(send=lambda to, req: sent.append((to, req)),
            resolve=lambda user: None, hlr=hlr)
    q._sent = sent
    return q, hlr


def _reply_to(smq, sender):
    """The most recent queued reply addressed to `sender`."""
    for m in sorted(smq._heap, key=lambda m: -m.seq):
        if m.to == sender:
            return m.body
    return None


def test_shortcode_101_register(smq_hlr):
    """shortcode_register (smcommands.cpp:225-358): number parsing,
    duplicate checks, HLR addUser."""
    smq, hlr = smq_hlr
    imsi = "901550000000002"
    smq.submit(imsi, "101", "(555) 867 5309 12")
    assert "Welcome to the free cellular network, 555867530912" in \
        _reply_to(smq, imsi)
    assert hlr.get_clid(imsi) == "555867530912"
    # registering the same IMSI again: "already registered"
    smq.submit(imsi, "101", "5550000000")
    assert "already registered" in _reply_to(smq, imsi)
    # someone else grabbing the same number: "already in use"
    smq.submit("901550000000003", "101", hlr.get_clid(imsi))
    assert "already in use" in _reply_to(smq, "901550000000003")
    # malformed numbers
    smq.submit("901550000000004", "101", "12ab34")
    assert "invalid" in _reply_to(smq, "901550000000004")
    smq.submit("901550000000005", "101", "123")
    assert "10-digit" in _reply_to(smq, "901550000000005")
    smq.submit("901550000000006", "101", "55+5")
    assert "+ can only be first" in _reply_to(smq, "901550000000006")


def test_shortcode_2337_quick_chk(smq):
    smq.submit("1001", "2001", "hello")  # one real queued message
    smq.submit("1001", "2337", "")
    assert "1 queued." in _reply_to(smq, "1001")


def test_shortcode_2338_zap(smq):
    m = smq.submit("1001", "2001", "hello")
    tag = str(m.seq)
    smq.submit("1001", "2338", "nosuch")
    assert "No message queued with tag 'nosuch'" in _reply_to(smq, "1001")
    smq.submit("1001", "2338", tag)
    assert not any(x.seq == m.seq for x in smq._heap)
    assert "Deleting queued msg" in _reply_to(smq, "1001")
    # '-' prefix: act silently
    m2 = smq.submit("1001", "2001", "hello2")
    n_before = smq.queue_size()
    smq.submit("1001", "2338", f"-{m2.seq}")
    assert smq.queue_size() == n_before - 1  # removed, no reply queued


def test_shortcode_314158_whiplash(smq):
    smq.submit("1001", "314158", "Snidely quit")
    assert smq.quit_requested
    # non-Snidely traffic to the code queues as an ordinary message
    n0 = smq.queue_size()
    m = smq.submit("1001", "314158", "ordinary text")
    assert smq.queue_size() == n0 + 1
    assert m.state == INITIAL_STATE
    smq.submit("1001", "314158", "Snidely frobnicate")
    assert "Unknown Command" in _reply_to(smq, "1001")


def test_shortcode_testsave(tmp_path, smq, monkeypatch):
    smq.submit("1001", "2001", "keep me")
    monkeypatch.chdir(tmp_path)
    smq.submit("1001", "314158", "Snidely testsave")
    assert "Done." in _reply_to(smq, "1001")
    saved = (tmp_path / "testsave.txt").read_text()
    assert "keep me" in saved


def test_shortcode_2336_debug_dump(smq):
    smq.submit("1001", "2001", "queued thing")
    n0 = smq.queue_size()
    smq.submit("1001", "2336", "")
    assert smq.queue_size() == n0  # SCA_DONE: no reply queued


def test_queue_save_and_reload(tmp_path, smq):
    """Boot-time queue reload (read_queue_from_file, smqueue.cpp:2041;
    wired at startup :2225-2232): submit → save → new SMq → load →
    delivery proceeds with states, retries and remaining timeouts
    intact."""
    import time as systime

    now = systime.monotonic()
    m1 = smq.submit("1001", "2001", "persist me")
    m2 = smq.submit("1002", "2002", "multi\nline body")
    m2.retries = 3
    m2.dest_imsi = "001010123456789"
    m2.call_id = "abc@host"
    # advance m1 into a waiting state with a pending timeout
    drive(smq, now, 2)
    pending = [m for m in smq._heap
               if m.state != ShortMsgState.DeleteMeState]
    assert pending
    path = tmp_path / "savedqueue.txt"
    n = smq.save_queue_to_file(str(path), now=now)
    assert n == len(smq._heap)

    sent2 = []
    q2 = SMq(send=lambda to, req: sent2.append((to, req)),
             resolve=lambda user: smq._registry.get(user))
    loaded = q2.read_queue_from_file(str(path), now=now)
    assert loaded == len([m for m in smq._heap
                          if m.state != ShortMsgState.DeleteMeState])
    by_key = {(m.frm, m.to): m for m in q2._heap}
    r1 = by_key[("1001", "2001")]
    r2 = by_key[("1002", "2002")]
    assert r1.body == "persist me"
    assert r2.body == "multi\nline body"
    assert r2.retries == 3 and r2.dest_imsi == "001010123456789"
    assert r2.call_id == "abc@host"
    # states and remaining timeouts survive
    orig = {(m.frm, m.to): m for m in smq._heap}
    for k, r in by_key.items():
        assert r.state == orig[k].state
        assert abs(r.next_action_time - orig[k].next_action_time) < 0.01
    # delivery proceeds on the reloaded queue
    for _ in range(8):
        q2.process_queue(now=systime.monotonic() + 1e6)
    assert any(to == "2001" for to, _ in sent2), \
        "reloaded message was not delivered"


def test_queue_reload_skips_bad_records(tmp_path, smq):
    path = tmp_path / "q.txt"
    good = smq.submit("1001", "2001", "ok")
    smq.save_queue_to_file(str(path))
    text = path.read_text()
    path.write_text("=== bogus header line\n" + text +
                    "=== 1 0.0 0 a b - - - 99999\ntrunc\n")
    q2 = SMq(send=lambda to, req: None, resolve=lambda u: None)
    assert q2.read_queue_from_file(str(path)) == 1
    assert q2._heap[0].body == "ok"
    assert q2.read_queue_from_file(str(tmp_path / "missing.txt")) == 0


def test_queue_reload_non_ascii_bodies(tmp_path, smq):
    """The header's length field counts BYTES; a non-ASCII body must
    not mis-frame the records that follow it (the reference smqueue
    round-trips byte-exact)."""
    smq.submit("1001", "2001", "héllo wörld €5 ✓✓✓")
    smq.submit("1002", "2002", "plain follower")
    path = tmp_path / "q.txt"
    smq.save_queue_to_file(str(path))
    q2 = SMq(send=lambda to, req: None, resolve=lambda u: None)
    assert q2.read_queue_from_file(str(path)) == 2
    by_key = {(m.frm, m.to): m for m in q2._heap}
    assert by_key[("1001", "2001")].body == \
        "héllo wörld €5 ✓✓✓"
    assert by_key[("1002", "2002")].body == "plain follower"


def test_bounce_sends_error_sms_from_411(smq):
    """bounce_message (smqueue.cpp:1103-1148): a message that exhausts
    delivery is bounced as an error SMS from "411" to the original
    sender — except when the sender IS 411 (endless-loop guard)."""
    import time as systime

    now = systime.monotonic()
    smq.submit("1001", "9999", "hello nowhere")  # unresolvable dest
    for _ in range(40):
        now += 1e5
        smq.process_queue(now=now)
    assert smq.failed, "undeliverable message never gave up"
    bounce = next((m for m in smq._heap if m.frm == "411"
                   and m.to == "1001"), None) or \
        next((m for m in smq.delivered + smq.failed
              if m.frm == "411" and m.to == "1001"), None)
    assert bounce is not None, "no bounce SMS queued to the sender"
    assert "Can't send your SMS to 9999" in bounce.body
    assert "hello nowhere" in bounce.body

    # loop guard: a failing message FROM 411 does not bounce again
    n_before = sum(1 for m in smq._heap if m.frm == "411")
    smq.submit("411", "9999", "system text")
    for _ in range(40):
        now += 1e5
        smq.process_queue(now=now)
    n_after = sum(1 for m in smq._heap if m.frm == "411")
    assert n_after <= n_before, "411-originated failure bounced (loop)"


# ---- against the JAX package ------------------------------------------------

def test_tables_equal_jax():
    from openbts_ttsou_tpu.smqueue import queue as jq
    from openbts_ttsou_tpu_torch.smqueue import queue as tq

    assert [(s.name, int(s)) for s in tq.ShortMsgState] == \
        [(s.name, int(s)) for s in jq.ShortMsgState]
    assert tq.TIMEOUTS == jq.TIMEOUTS
    assert {int(k): int(v) for k, v in tq.TIMEOUT_NEXT_STATE.items()} == \
        {int(k): int(v) for k, v in jq.TIMEOUT_NEXT_STATE.items()}
    assert {int(k): (t, int(n)) for k, (t, n) in tq.STATE_TIMEOUTS.items()} \
        == {int(k): (t, int(n)) for k, (t, n) in jq.STATE_TIMEOUTS.items()}


def test_message_walk_equals_jax():
    """One MESSAGE submitted, driven through delivery and its 200 OK, in
    both packages: the same states at the same times and the same
    requests (Call-IDs, tags and branches aside)."""
    from openbts_ttsou_tpu.smqueue import SMq as JSMq

    def walk(cls):
        sent = []
        q = cls(send=lambda to, req: sent.append((to, req)),
                resolve=lambda user: user if user.startswith("2") else None)
        m = q.submit("1001", "2001", "hello there")
        states = []
        now = time.time()
        for k in range(6):
            q.process_queue(now + 100 * k)
            states.append(int(m.state))
        lines = [(to, [ln for ln in req.splitlines()
                       if ln.split(":")[0].lower() in ("content-type",
                                                      "content-length")]
                  + [req.splitlines()[0], req.split("\r\n\r\n")[-1]])
                 for to, req in sent]
        return states, lines

    got = walk(SMq)
    assert got == walk(JSMq)
    assert len(got[1]) >= 1 and len(set(got[0])) > 1  # it moved and sent


def test_command_line_entry_point(tmp_path):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "openbts_ttsou_tpu_torch.smqueue", "--help"],
        capture_output=True, text=True, timeout=60,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0 and "--savefile" in out.stdout
