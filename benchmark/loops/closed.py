"""The closed loop: `clients` callers, each calling the program on the next
draw of the pool, waiting for its output in host memory and calling again,
until `seconds` have passed since the window opened.  One client runs in
the calling thread; more run in threads of their own, each on a CUDA stream
of its own on a card.  The tracer, if any, covers the window's trailing
`tracer.seconds`."""

import threading
import time


class Op:
    __slots__ = ("index", "inst", "t0", "t1", "out", "error")

    def __init__(self, index, inst, t0, t1, out, error):
        self.index, self.inst, self.t0, self.t1 = index, inst, t0, t1
        self.out, self.error = out, error


def drive(program, take, seconds, tracer, clients, device):
    """(records, t0, t1): one Op a call, in the order the calls ended."""
    import torch

    records, lock = [], threading.Lock()
    t0 = time.perf_counter()
    stop = t0 + seconds

    def client(lead):
        while True:
            now = time.perf_counter()
            if now >= stop and records:
                return
            if lead and tracer and tracer.first is None and now >= stop - tracer.seconds:
                tracer.start(len(records))
            j, inst = take()
            out = error = None
            try:
                out = program.run(j)
            except Exception as e:           # a failed operation is counted, not fatal
                error = f"{type(e).__name__}: {e}"
            with lock:
                records.append(Op(len(records), inst, now, time.perf_counter(), out, error))

    def on_stream():
        with torch.cuda.stream(torch.cuda.Stream(device)):
            client(False)

    others = [threading.Thread(target=on_stream if device.type == "cuda" else client,
                               args=() if device.type == "cuda" else (False,))
              for _ in range(clients - 1)]
    for t in others:
        t.start()
    if clients > 1 and device.type == "cuda":
        with torch.cuda.stream(torch.cuda.Stream(device)):
            client(True)
    else:
        client(True)
    for t in others:
        t.join()
    t1 = time.perf_counter()
    if tracer:
        if tracer.first is None:
            tracer.start(len(records))
        tracer.stop()
    return records, t0, t1
