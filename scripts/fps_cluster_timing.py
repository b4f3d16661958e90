#!/usr/bin/env python3
"""FPS above 8192 points on one GPU: the cluster routes by cluster size.

    python3 scripts/fps_cluster_timing.py [--other TREE] [--reps 20]

Builds ``mocopci_torch/csrc/fps.cu`` alone (with ``-Xptxas -v``).  Holds
``fps_cluster`` and ``fps_pyramid_cluster`` bit for bit against the plain
versions at each cluster size that holds the cloud (2, 4 and 8 blocks), over
3 launches, at the stress forward's calls: the refine head's (3, n) -> n/4
and the encoder's pyramid (2, n) -> n/4, n/16, n/32, n/128 for n in 16384
and 32768, and (2, 32768) -> 8192 on a cloud whose upper half repeats the
lower (every step ties across spans).  Then it times, by CUDA events (median
of ``--reps``), each size in µs a step (the time over the steps of every
level), at those calls and at 12288 points, beside the one-block route at
8192 points.

``--other TREE`` (another checkout, for example the parent commit from
``git archive``) builds that tree's ``fps.cu`` too ("there"; both builds
started together), holds and times its cluster routes in turns with this
tree's ("here": there, here, here, there), compares its one-block kernels'
SASS with this tree's (the first differing lines printed) and times its
``fps`` and ``fps_pyramid`` at 8192 points beside this tree's in the same
turns.  The size chosen is ``CLUSTER`` in ``mocopci_torch/kernels/fps.py``;
the card tests (``tests/test_torch_cuda.py``) hold it at every size.
"""
import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mocopci_torch.kernels import _lib  # noqa: E402

fps_mod = importlib.import_module("mocopci_torch.kernels.fps")
ENTRIES = ("fps", "fps_pyramid", "fps_cluster", "fps_pyramid_cluster")


def start_build(tree, tag):
    """Start building that tree's fps.cu and common.cu into a library of
    their own; returns a function that waits and gives (library, path)."""
    out_dir = os.path.join(ROOT, "build", "fps_cluster")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"libfps_{tag}.so")
    csrc = os.path.join(tree, "mocopci_torch", "csrc")
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", csrc, "-o", out,
           os.path.join(csrc, "fps.cu"), os.path.join(csrc, "common.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        text, _ = proc.communicate()
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line or "error" in line:
                print(f"{tag}: {line}", flush=True)
        if proc.returncode:
            raise SystemExit(text)
        lib = ctypes.CDLL(out)
        cs.bind_entries(lib, _lib.SIGNATURES, ENTRIES)
        return lib, out
    return finish


def one_block_sass(path):
    """kernel name -> its SASS lines (the function's header line dropped,
    whitespace collapsed), for the one-block kernels of the library at
    ``path``."""
    text = subprocess.run([os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump"), "-sass",
                           path], capture_output=True, text=True, check=True).stdout
    kernels = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = part.split("\n", 1)
        for k in ("fps_pyramid_kernel", "fps_kernel"):
            if re.search(rf"\d{k}E", name):
                # cuobjdump aligns its columns to the file's longest line
                kernels[k] = [" ".join(line.split()) for line in body.splitlines()
                              if line.strip()]
    return kernels


def stress_levels(n):
    return (n // 4, n // 16, n // 32, n // 128)


def sizes(N):
    return [c for c in (2, 4, 8) if -(-N // c) <= fps_mod.BLOCK_MAX_N]


def calls(dev):
    """(label, cloud, what, steps): the stress calls, largest first."""
    g = torch.Generator(device=dev).manual_seed(4)
    out = []
    for N in (32768, 16384, 12288):
        tri = torch.randn(3, N, 3, generator=g, device=dev) * 10
        pair = tri[:2].contiguous()
        out.append((f"fps_cluster (3, {N}) -> {N // 4}", tri, N // 4, N // 4 - 1))
        lv = stress_levels(N)
        out.append((f"fps_pyramid_cluster (2, {N}) -> {lv}", pair, lv, sum(n - 1 for n in lv)))
    return out


def check_bits(libs, dev) -> None:
    """Each library's cluster routes against the plain versions at every
    size, 3 launches each; raises on a mismatch."""
    g = torch.Generator(device=dev).manual_seed(6)
    dup = torch.randn(2, 32768, 3, generator=g, device=dev) * 10
    dup[:, dup.shape[1] // 2:] = dup[:, :dup.shape[1] // 2].clone()
    cases = [(label, xyz, what) for label, xyz, what, _ in calls(dev) if xyz.shape[1] != 12288]
    cases.append(("fps_cluster (2, 32768) -> 8192, duplicated halves", dup, 8192))
    bad = []
    for label, xyz, what in cases:
        want = (torch.cat([i.reshape(-1) for i in fps_mod.fps_pyramid_plain(xyz, what)])
                if isinstance(what, tuple) else fps_mod.fps_plain(xyz, what))
        for tag, lib in libs.items():
            for c in sizes(xyz.shape[1]):
                same = [torch.equal(cs.launch_fps(lib, xyz, what, c).reshape(want.shape), want)
                        for _ in range(3)]
                print(f"bits {tag} c{c} {label}: equal to the plain version over 3 launches "
                      f"{same}", flush=True)
                if not all(same):
                    bad.append((tag, c, label))
    if bad:
        raise SystemExit(f"cluster FPS differs from the plain version: {bad}")


def compare_other(here_path, other, other_path, dev, reps) -> None:
    """That tree's one-block kernels against this tree's: SASS, then time at
    8192 points in turns."""
    here_sass, there_sass = one_block_sass(here_path), one_block_sass(other_path)
    for k in ("fps_kernel", "fps_pyramid_kernel"):
        a, b = there_sass.get(k, []), here_sass.get(k, [])
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        print(f"sass {k}: {len(a)} lines there, {len(b)} here, {len(diff)} differ", flush=True)
        for x, y in diff[:10]:
            print(f"  there: {x}\n  here:  {y}", flush=True)
    g = torch.Generator(device=dev).manual_seed(5)
    xyz6 = torch.randn(6, 8192, 3, generator=g, device=dev) * 10
    xyz2 = xyz6[:2].contiguous()
    lv = (2048, 512, 256, 64)
    here_lv = torch.cat([t.reshape(-1) for t in fps_mod.fps_pyramid(xyz2, lv)])
    same = (torch.equal(cs.launch_fps(other, xyz6, 2048), fps_mod.fps(xyz6, 2048))
            and torch.equal(cs.launch_fps(other, xyz2, lv), here_lv))
    print(f"other tree's one-block FPS bit-equal to this tree's: {same}", flush=True)
    for what, there_fn, here_fn, steps in (
            ("fps (6, 8192) -> 2048", lambda: cs.launch_fps(other, xyz6, 2048),
             lambda: fps_mod.fps(xyz6, 2048), 2047),
            (f"fps_pyramid (2, 8192) -> {lv}", lambda: cs.launch_fps(other, xyz2, lv),
             lambda: fps_mod.fps_pyramid(xyz2, lv), sum(n - 1 for n in lv))):
        ms = [cs.median_ms(f, reps) for f in (there_fn, here_fn, here_fn, there_fn)]
        print(f"time {what}: ms there {ms[0]:.4f} / {ms[3]:.4f}, here {ms[1]:.4f} / {ms[2]:.4f}, "
              f"in turns; us a step there {1e3 * ms[0] / steps:.4f} / {1e3 * ms[3] / steps:.4f}, "
              f"here {1e3 * ms[1] / steps:.4f} / {1e3 * ms[2] / steps:.4f}", flush=True)


def time_all(libs, dev, reps) -> None:
    g = torch.Generator(device=dev).manual_seed(4)
    xyz3 = torch.randn(3, 8192, 3, generator=g, device=dev) * 10
    ms = cs.median_ms(lambda: fps_mod.fps(xyz3, 2048), reps)
    print(f"time fps one block (3, 8192) -> 2048: {ms:.4f} ms ({1e3 * ms / 2047:.4f} us a step)",
          flush=True)
    tags = list(libs)
    order = tags + tags[::-1]
    for label, xyz, what, steps in calls(dev):
        for c in sizes(xyz.shape[1]):
            got = {t: [] for t in tags}
            for t in order:
                got[t].append(cs.median_ms(lambda: cs.launch_fps(libs[t], xyz, what, c), reps))
            print(f"time c{c} {label}: " + "; ".join(
                f"{t} {' / '.join(f'{m:.4f}' for m in got[t])} ms "
                f"({' / '.join(f'{1e3 * m / steps:.4f}' for m in got[t])} us a step)"
                for t in tags), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", metavar="TREE", help="another checkout whose FPS kernels are "
                    "held, compared (one-block SASS) and timed beside this tree's")
    ap.add_argument("--reps", type=int, default=cs.REPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fps_cluster_timing: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    builds = {"here": start_build(ROOT, "here")}
    if args.other:
        builds = {"there": start_build(args.other, "there"), **builds}
    built = {tag: finish() for tag, finish in builds.items()}
    _lib._lib = built["here"][0]
    dev = torch.device("cuda")
    libs = {tag: lib for tag, (lib, _) in built.items()}
    if args.other:
        compare_other(built["here"][1], libs["there"], built["there"][1], dev, args.reps)
    check_bits(libs, dev)
    time_all(libs, dev, args.reps)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
