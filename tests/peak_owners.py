"""Who holds a dry-run step's peak: the storages live when the analysed
peak a rank is reached, grouped by the port's frames that allocated them.

Runs ``launch.dryrun.run_one`` on ``meta`` (the 16x16 pod mesh of a fake
256-rank group, as the dry run does) with ``roofline.analysis._Trace``'s
``track``, ``_bump`` and ``loop_end`` wrapped: each storage of at least
``--min-mib`` notes its allocating frames, and each new peak (and each
cut loop's, which ``loop_end`` extrapolates to the full loop) keeps a
snapshot of what is live.  Prints each owner's bytes at the peak, its
storages and the largest, largest owner first, and the rest (smaller
storages, a kernel's scratch) as one line.  A storage allocated in the
backward shows the frame that called it (``l.backward()``), and one that
no frame of the port made (the autograd engine's own) shows as ``?``.
Not collected by pytest.

    PYTHONPATH=src python tests/peak_owners.py --arch xlstm-350m \\
        --shape train_4k [--layers N] [--top 12] [--json out.json]
"""

import argparse
import json
import traceback
from collections import defaultdict


def _where(depth: int) -> str:
    """The innermost ``depth`` frames of the port (file:line function)."""
    frames = [f for f in traceback.extract_stack()[:-2]
              if "repro_torch" in f.filename
              and "roofline/analysis.py" not in f.filename]
    return " < ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} "
                      f"{f.name}" for f in reversed(frames[-depth:]))


def owners(arch: str, shape: str, layers=None, min_mib: int = 64,
           depth: int = 3):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis as A

    least = min_mib * 2**20
    origin = {}
    state = {"snap": None, "live": 0}

    def snap(trace):
        held = defaultdict(lambda: [0, 0, 0])  # bytes, storages, largest
        for key, (n, mult) in trace.storages.items():
            if n >= least:
                who = "argument" if key in trace.args else \
                    origin.get(key, "?")
                row = held[who]
                row[0] += n * mult
                row[1] += mult
                row[2] = max(row[2], n)
        return {k: list(v) for k, v in held.items()}, trace.live

    track, bump, loop_end = A._Trace.track, A._Trace._bump, \
        A._Trace.loop_end

    def w_track(self, st, *, arg=False):
        fresh = track(self, st, arg=arg)
        if fresh and not arg and st.nbytes() >= least:
            origin[st._cdata] = _where(depth)
        return fresh

    def w_bump(self, amount):
        before = self.peak, {id(lp): lp.peak for lp in self.open}
        bump(self, amount)
        if self.peak > before[0] and self.peak >= 1.001 * state["live"]:
            state["snap"], state["live"] = snap(self)
        for lp in self.open:
            if lp.peak > before[1][id(lp)] and \
                    lp.peak >= 1.001 * getattr(lp, "snap_live", 0):
                lp.snap, lp.snap_live = snap(self)

    def w_loop_end(self, lp):
        if lp is not None and getattr(lp, "snap", None) is not None:
            kept = [(key, e) for key, e in lp.kept
                    if self.storages.get(key) is e]
            extra = (lp.n - 3) * sum(e[0] for _, e in kept)
            if lp.peak + extra > self.peak:
                held = {k: list(v) for k, v in lp.snap.items()}
                for key, e in kept:
                    if e[0] >= least:
                        who = origin.get(key, "?") + \
                            f" [x{lp.n - 3} more steps]"
                        row = held.setdefault(who, [0, 0, 0])
                        row[0] += (lp.n - 3) * e[0]
                        row[1] += lp.n - 3
                        row[2] = max(row[2], e[0])
                state["snap"] = held
                state["live"] = lp.snap_live + extra
        return loop_end(self, lp)

    A._Trace.track, A._Trace._bump, A._Trace.loop_end = \
        w_track, w_bump, w_loop_end
    try:
        rec = dryrun.run_one(arch, shape, False, verbose=False, save=False,
                             layers=layers)
    finally:
        A._Trace.track, A._Trace._bump, A._Trace.loop_end = \
            track, bump, loop_end
    held, live = state["snap"] or {}, state["live"]
    rows = sorted(held.items(), key=lambda kv: -kv[1][0])
    return dict(arch=arch, shape=shape, layers=layers,
                peak_bytes=rec.get("peak_memory_bytes"), snapshot_live=live,
                owners=[dict(owner=k, bytes=v[0], storages=v[1],
                             largest=v[2]) for k, v in rows],
                rest=live - sum(v[0] for v in held.values()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--min-mib", type=int, default=64)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = []
    for arch in args.arch:
        r = owners(arch, args.shape, args.layers, args.min_mib, args.depth)
        out.append(r)
        print(f"{arch} {args.shape}: peak {r['peak_bytes'] / 2**30:.2f} GiB "
              f"a rank (snapshot {r['snapshot_live'] / 2**30:.2f})")
        for row in r["owners"][:args.top]:
            print(f"  {row['bytes'] / 2**30:9.3f} GiB in {row['storages']:4d}"
                  f" (largest {row['largest'] / 2**30:.3f})  {row['owner']}")
        print(f"  {r['rest'] / 2**30:9.3f} GiB  the rest (storages under "
              f"{args.min_mib} MiB, kernel scratch)", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
