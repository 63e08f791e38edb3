"""The admission order of a tp = 1 mesh pool, on the card: rank 0's
pipelined admission threads (the single-card server's) against the mesh
server's plan-order admissions on the tick thread, on one dp 2 pool.

    python3 sesameai_tts_tpu_torch/csrc/probes/mesh_admissions.py [--rounds N]

Two processes share the one card over gloo, as ``chip_smoke.py``'s
``main[mesh]`` does; each builds CSM-1B int8 from seed 0 on a (2, 1) mesh,
then serves ``chip_smoke.MESH_SESSIONS`` on a fresh, warmed-up 4-slot
server over the same Generator in the order pipelined, plan, plan,
pipelined (N times), and rank 0 prints each round's frames/s, wall per
frame-step and TTFA, and whether its codes equal the first round's.  The
pipelined rounds run ``_Pipelined`` below: rank 0 prefills each session on
its admission threads beside the ticks, and the rank that holds its slot
prefills it again from the plan's rows at the next tick.
Needs a card; not part of the package's build or tests.
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TIMEOUT_S = 600


def _pipelined_server():
    """The mesh server with rank 0's admissions pipelined on its admission
    threads, the plan carrying their prompt rows and seeds."""
    import queue

    from sesameai_tts_tpu_torch.runtime import serving as sv

    class _Pipelined(sv.BatchedTTSServer):
        def start(self):
            self._planned, self._items = {}, {}
            super().start()  # a follower returns when rank 0 stops
            if self._front:
                self._admitter_thread = sv.threading.Thread(target=self._dispatch_loop,
                                                            daemon=True)
                self._admitter_thread.start()
                self._completer = sv.threading.Thread(target=self._completion_loop,
                                                      daemon=True)
                self._completer.start()

        def _dispatch_admission(self, session):
            a = self._admitter
            seed = a._utterance_seed(None)
            try:
                tokens, mask = a._tokenize_prompt(session.text, session.speaker,
                                                  list(session.context))
                with sv._on(a):
                    frame, state1, done1, max_gen = a._prefill_admission(
                        None, None, None, None, int(session.max_audio_length_ms / sv.FRAME_MS),
                        session.temperature, session.topk, seed, rows=(tokens, mask))
                    pcm0, ms1 = a._first_chunk(frame)
                    fetch = sv._Fetch([done1, frame, pcm0])
            except Exception as e:
                session.error = e
                session.chunks.put(None)
                return None
            self._planned[id(session)] = (seed, tokens, mask)
            return sv._Admitted(session, frame, state1, max_gen, ms1, fetch)

        def _plan_admissions(self):
            idle = [s for s in range(self.B) if self._sessions[s] is None]
            admits, front = [], {}
            while idle:
                try:
                    item = self._ready.get_nowait()
                except queue.Empty:
                    break
                session = item.session
                seed, tokens, mask = self._planned.pop(id(session))
                if session.cancelled:
                    session.chunks.put(None)
                    continue
                slot = idle.pop(0)
                admits.append(sv._Admission(slot, seed, session.temperature, session.topk,
                                            item.max_gen, tokens, mask))
                front[slot], self._items[slot] = session, item
            return tuple(admits), front

        def _admit_on_front(self, a, session):
            self._attach(a.slot, self._items.pop(a.slot))  # prefilled already

    return _Pipelined


def _rank(rank: int, world: int, tmp: str, orders: list) -> None:
    import numpy as np
    import torch.distributed as dist

    from sesameai_tts_tpu_torch.parallel.mesh import make_mesh
    from sesameai_tts_tpu_torch.runtime.loader import build_generator, csm_1b_spec
    from sesameai_tts_tpu_torch.runtime.serving import BatchedTTSServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda:0")
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        gen = build_generator(csm_1b_spec(), device="cuda:0", mesh=make_mesh(2, 1))
        rounds = []
        for order in orders:
            server = BatchedTTSServer if order == "plan" else _pipelined_server()
            srv = server(gen, slots=4, chunk_frames=cs.MESH_CHUNK)
            srv.warmup()
            srv.start()  # a follower returns when rank 0 stops
            if rank == 0:
                try:
                    out = cs._mesh_sessions(np, srv)
                finally:
                    srv.stop()
                rounds.append({"order": order, **out})
        if rank == 0:
            with open(os.path.join(tmp, "rounds.json"), "w") as f:
                json.dump(rounds, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp

    n = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 1
    orders = ["pipelined", "plan", "plan", "pipelined"] * n
    name, card = cs.phase_device(torch)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(2, tmp, orders), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks outlived {TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(os.path.join(tmp, "rounds.json")) as f:
            rounds = json.load(f)
    first = rounds[0]["codes"]
    for r in rounds:
        print("mesh admissions " + json.dumps({
            "order": r["order"], "codes_equal_to_round_0": r["codes"] == first,
            **{k: r[k] for k in ("frames_per_s", "ms_per_frame_step", "ttfa_p50_s",
                                 "ttfa_max_s", "ticks", "frame_steps", "wall_s")}}), flush=True)
    for order in ("pipelined", "plan"):
        rs = [r for r in rounds if r["order"] == order]
        print(f"mesh admissions {order} mean " + json.dumps({
            k: sum(r[k] for r in rs) / len(rs)
            for k in ("frames_per_s", "ms_per_frame_step", "ttfa_p50_s")}), flush=True)
    print(card, flush=True)
    return 0 if all(r["codes"] == first for r in rounds) else 1


if __name__ == "__main__":
    sys.exit(main())
