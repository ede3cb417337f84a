"""LM decode serving: :class:`Request` + :class:`DecodeEngine`.

DecodeEngine is a continuous-batching engine on top of
:class:`repro_torch.serve.core.FifoEngineCore`: a fixed pool of ``batch``
lanes (slots), each carrying its own position counter.  Every
:meth:`DecodeEngine.step` is ONE decode step over the whole pool (the
paper's implicit vector masking applied to the request dimension):
slots mid-prefill consume their next prompt token, generating slots
consume their last output token, idle slots are fed a benign token at
position 0 and their logits discarded.  A finishing request frees only
its slot; the next queued request prefills into that slot while the
other slots keep generating — no pool-wide barrier, no cache rebuild.

Slot-level paged KV reuse: :func:`repro_torch.models.attention.
attention_decode` masks each slot's attention to its live length
``pos + 1``, so a freed slot is reused by resetting its position to 0 —
the new request's tokens overwrite the slot's cache pages sequentially
and the stale tail beyond the live position is never read.  A recurrent
state (Mamba2, mLSTM, sLSTM) has no such mask, and a slot's state moves
at every pool step, idle or not; so every slot handed to a request is
first given a fresh slot's state (:func:`repro_torch.models.decode.
reset_slots`, nothing for the dense family).  The reference's engine
does not, and a reused slot there carries its last request's state.

Selection is per slot: a greedy request takes the argmax and never draws
a random number, so its output is independent of its pool-mates; a
sampling request draws from a ``torch.Generator`` seeded from the
engine's seed, the request's ``seq`` and its output index, so pool-mates
share no stream and the same ``seq`` replays the same draws.  (JAX's
``fold_in`` streams cannot be matched bit for bit: greedy decoding is
what equals the reference, sampling only its independence.)  The
lockstep baseline, :meth:`DecodeEngine.run_lockstep`, keeps the
historical pool-wide behaviour: any sampling member switches the whole
pool to one shared stream.

The shared core supplies the queue, the clocks and the lane/latency
accounting; per-phase (insert / prefill / generate) samples land in
:class:`repro_torch.serve.metrics.DecodeStats`.  Attached to a
:class:`repro_torch.serve.mux.SolverMux` the engine shares the mux's
recorder, clocks and event stream (``event_cb``) and feeds measured step
wall-clock to the cost model (``observe_cb``).

The engine runs where its parameters lie and on a copy of them cast once
to the compute dtype (:func:`repro_torch.models.transformer.
cast_params`), the values each use would cast them to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import decode as D
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import cast_params
from repro_torch.serve.core import FifoEngineCore


@dataclasses.dataclass
class Request:
    """One decode request.  ``priority``/``deadline`` use the same
    admission classes as :class:`repro_torch.serve.mux.SolveJob` ("hard"
    is never shed); ``seq`` is assigned at submit (by the mux when
    attached) and seeds the request's private random stream."""
    prompt: list[int]
    max_new: int = 32
    temperature: float = 0.0
    priority: str = "best_effort"
    deadline: float | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    dropped: bool = False
    submitted_at: float | None = None
    inserted_at: float | None = None
    finished_at: float | None = None
    seq: int | None = None


class DecodeEngine(FifoEngineCore):
    def __init__(self, cfg: ArchConfig, params: dict, batch: int = 8,
                 max_len: int = 512, eos_id: int = 1, seed: int = 0,
                 clock=None, device=None):
        if device is None:
            device = params["embed"].device
        super().__init__(batch, clock=clock, device=device)
        self.cfg = cfg
        self.params = cast_params(params, cfg)
        self.max_len = max_len
        self.eos = eos_id
        self.seed = seed
        self.cache = D.init_cache(cfg, self.lanes, max_len,
                                  device=self.device)
        # the lockstep baseline's pool-wide stream
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        # the servable decode spec: phase names + closed-form per-token
        # FLOPs, the unit the mux prices decode steps in
        from repro_torch import kernels as K
        self.spec = K.get_decode("lm_decode")
        self.token_flops = self.spec.token_flops(cfg)
        # per-slot continuous-batching state
        self._slot_req: list[Request | None] = [None] * self.lanes
        self._slot_fed = [0] * self.lanes     # tokens fed == position
        self._slot_dirty = [False] * self.lanes  # held a prior request
        self._slot_wall0 = [0.0] * self.lanes    # insert wall stamp
        self._slot_gen0 = [0.0] * self.lanes     # first-output stamp
        self.steps = 0                # pool steps executed (both paths)
        self.tokens = 0               # tokens generated (both paths)
        self._serial = 0
        # mux attachment hooks (None when the engine runs standalone)
        self.event_cb = None          # (kind, t, **fields)
        self.observe_cb = None        # (phase, flops, measured_seconds)

    # ---------------- submission / queue state ----------------

    def submit(self, item: Request) -> Request:
        if not item.prompt:
            raise ValueError("decode request needs a non-empty prompt")
        if len(item.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(item.prompt)} tokens does not fit the "
                f"{self.max_len}-token cache")
        # a request can never outgrow its slot's cache pages
        item.max_new = min(item.max_new, self.max_len - len(item.prompt))
        if item.seq is None:
            self._serial += 1
            item.seq = self._serial
        return super().submit(item)

    def occupied(self) -> int:
        """Slots currently holding an unfinished request."""
        return sum(r is not None for r in self._slot_req)

    def has_work(self) -> bool:
        return bool(self.pending() or self.occupied())

    def hard_waiting(self) -> bool:
        """Any hard-deadline request queued or in flight (the overload
        policy never defers decode while this holds)."""
        return any(r.priority == "hard" for r in self._queue) or any(
            r is not None and r.priority == "hard" for r in self._slot_req)

    def shed_expired(self, now: float) -> list[Request]:
        """Drop queued best-effort requests whose deadline has passed.
        Hard-deadline requests are never shed, and a request already
        holding a slot is never shed mid-stream."""
        keep, shed = [], []
        for r in self._queue:
            if (r.priority != "hard" and r.deadline is not None
                    and r.deadline < now):
                r.dropped = True
                r.finished_at = now
                shed.append(r)
            else:
                keep.append(r)
        self._queue = keep
        return shed

    # ---------------- continuous batching ----------------

    def _finish(self, r: Request, slot: int | None, now: float,
                done: list) -> None:
        r.done = True
        self.recorder.record_decode_request()
        self.record_job("decode", r)
        if self.event_cb is not None:
            self.event_cb("decode_done", now, seq=r.seq,
                          tokens=len(r.out))
        if slot is not None:
            self._slot_req[slot] = None
        done.append(r)

    def _insert_waiting(self, done: list) -> None:
        """Fill free slots oldest-first from the FIFO.  Slot reuse is
        the paged-cache move: position resets to 0 and the incoming
        request's tokens overwrite the slot's pages sequentially — the
        stale tail past the live position is masked by construction.
        The recurrent states of the slots filled are reset to a fresh
        slot's (no K/V zeroing happens here)."""
        now = self.clock()
        filled = []
        for i in range(self.lanes):
            while self._slot_req[i] is None and self.pending():
                r = self.take(1)[0]
                r.inserted_at = now
                reused = self._slot_dirty[i]
                self._slot_dirty[i] = True
                self.recorder.record_decode_insert(reused)
                self.recorder.record_decode_phase(
                    "insert", now - r.submitted_at)
                if self.event_cb is not None:
                    self.event_cb("decode_insert", now, slot=i, seq=r.seq,
                                  prompt=len(r.prompt), max_new=r.max_new,
                                  priority=r.priority, reused=reused)
                if r.max_new <= 0:
                    self._finish(r, None, now, done)
                    continue
                self._slot_req[i] = r
                self._slot_fed[i] = 0
                self._slot_wall0[i] = self.wall()
                self._slot_gen0[i] = self._slot_wall0[i]
                filled.append(i)
        D.reset_slots(self.cfg, self.cache, filled)

    def _forward(self, toks: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode step over the pool: logits (lanes, V) float32."""
        logits, self.cache = D.decode_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device))
        return logits

    def _draw(self, logits: torch.Tensor, seq: int, index: int,
              temperature: float) -> torch.Tensor:
        """One sample of a request's private stream: the generator is
        seeded from (engine seed, request seq, output index), so the
        draw depends on nothing else."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + seq) * 1_000_003 + index)
        probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[0]

    def step(self) -> list[Request]:
        """One continuous-batching step: admit queued requests into free
        slots, feed every active slot its next token at its OWN position,
        select the next token per slot, retire finished requests.
        Returns the requests that finished this step."""
        done: list[Request] = []
        self._insert_waiting(done)
        active = [i for i in range(self.lanes)
                  if self._slot_req[i] is not None]
        if not active:
            return done
        toks = np.zeros((self.lanes, 1), np.int64)
        pos = np.zeros((self.lanes,), np.int64)
        for i in active:
            r, f = self._slot_req[i], self._slot_fed[i]
            toks[i, 0] = r.prompt[f] if f < len(r.prompt) else r.out[-1]
            pos[i] = f
        t0 = self.wall()
        logits = self._forward(toks, pos)
        nxt = torch.argmax(logits, dim=-1)
        for i in active:
            r = self._slot_req[i]
            if r.temperature > 0:
                # per-slot stream: a greedy slot never draws
                nxt[i] = self._draw(logits[i], int(r.seq or 0),
                                    len(r.out), r.temperature)
        nxt_np = nxt.cpu().numpy()
        dt = self.wall() - t0
        now = self.clock()
        made = prompt_feeds = 0
        for i in active:
            r, f = self._slot_req[i], self._slot_fed[i]
            self._slot_fed[i] = f + 1
            if f < len(r.prompt) - 1:
                # mid-prefill: logits discarded, next prompt token next
                prompt_feeds += 1
                continue
            if f == len(r.prompt) - 1:
                # this step consumed the final prompt token and its
                # logits are the first output token: prefill is done
                self.recorder.record_decode_phase(
                    "prefill", self.wall() - self._slot_wall0[i])
                self._slot_gen0[i] = self.wall()
            tok = int(nxt_np[i])
            r.out.append(tok)
            made += 1
            if tok == self.eos or len(r.out) >= r.max_new:
                self.recorder.record_decode_phase(
                    "generate", self.wall() - self._slot_gen0[i])
                self._finish(r, i, now, done)
        self.steps += 1
        self.tokens += made
        self.recorder.record_decode_step(made)
        self.record_launch("decode", ("step", self.lanes), len(active),
                           self.lanes - len(active), measured=dt)
        if self.observe_cb is not None:
            phase = ("prefill" if prompt_feeds > len(active) - prompt_feeds
                     else "generate")
            self.observe_cb(phase, len(active) * self.token_flops, dt)
        return done

    def run(self) -> list[Request]:
        """Drain continuously: step until the queue and every slot are
        empty.  Unlike the lockstep baseline there is no pool barrier —
        freed slots re-admit queued requests between steps."""
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    # ---------------- preserved lockstep baseline ----------------

    def run_lockstep(self) -> list[Request]:
        """The original lockstep pool decode, kept as the measured
        baseline (and for the single-request bit-identity
        characterization): all pool members share ONE position counter,
        prompts are right-aligned, the pool runs to the LONGEST member,
        and the cache is rebuilt between pool generations.  It also
        keeps the historical pool-wide sampling behaviour — any sampling
        member switches the whole pool to one shared stream
        (``self.gen``) — which the per-slot path above fixes."""
        done: list[Request] = []
        while self.pending():
            active = self.take(self.lanes)
            n_real = len(active)
            # pad the pool
            while len(active) < self.lanes:
                active.append(Request(prompt=[self.eos], max_new=0))
            plen = max(len(r.prompt) for r in active)
            # right-align prompts into the shared position stream
            toks = np.full((self.lanes, plen), self.eos, np.int64)
            for i, r in enumerate(active):
                toks[i, plen - len(r.prompt):] = r.prompt
            pos = 0
            for j in range(plen - 1):
                self._forward(toks[:, j:j + 1],
                              np.full((self.lanes,), pos, np.int64))
                pos += 1
                self.steps += 1
            cur = toks[:, -1:]
            max_new = max(r.max_new for r in active)
            for _ in range(max_new):
                logits = self._forward(cur,
                                       np.full((self.lanes,), pos, np.int64))
                pos += 1
                self.steps += 1
                if any(r.temperature > 0 for r in active):
                    nxt = torch.multinomial(torch.softmax(logits, dim=-1),
                                            1, generator=self.gen)[:, 0]
                else:
                    nxt = torch.argmax(logits, dim=-1)
                nxt_np = nxt.cpu().numpy()
                for i, r in enumerate(active):
                    if not r.done and len(r.out) < r.max_new:
                        tok = int(nxt_np[i])
                        r.out.append(tok)
                        self.tokens += 1
                        if tok == self.eos:
                            r.done = True
                cur = nxt_np[:, None].astype(np.int64)
                if all(r.done or len(r.out) >= r.max_new for r in active):
                    break
            self.record_launch("decode", ("pool", self.lanes),
                               n_real, self.lanes - n_real)
            for r in active[:n_real]:
                if r.max_new > 0:
                    r.done = True
                    self.record_job("decode", r)
                    done.append(r)
            # fresh cache per pool generation (slot-level reuse is the
            # continuous path's paged-cache move)
            self.cache = D.init_cache(self.cfg, self.lanes, self.max_len,
                                      device=self.device)
        return done
