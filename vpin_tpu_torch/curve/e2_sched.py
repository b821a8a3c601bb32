"""The programs of the K2 and K3 group kernels, laid out from the stage
schedule of csrc/e2_sched.cuh.

The header holds one complete addition on E2 as a table of field operations
(kind, destination slot, operand slots, stage, virtual lane).  ``program``
lays it out for groups of G lanes as the E2Prog of csrc/e2.cuh: per mode
(the set of additions an element runs) and per stage, each lane's rows with
their slots resolved for the kernel's element layout, and the number of
product rounds; the wrappers pass it to the kernels, which copy it into
shared memory.  Virtual lane v of the j-th addition of a mode runs on lane
(v + j * width) % G, width being the stage's largest virtual lane + 1, each
lane's rows in table order.
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "e2_sched.cuh"


@lru_cache(maxsize=1)
def schedule():
    """-> (slots {name: index}, kinds [name], rows [(kind, dst, a, b,
    stage, lane)], defines {name: int}) as the header states them."""
    text = re.sub(r"//[^\n]*", "", HEADER.read_text())
    slots, nxt = {}, 0
    body = re.search(r"enum E2Slot \{(.*?)\};", text, re.S).group(1)
    for item in filter(None, (t.strip() for t in body.split(","))):
        name, _, value = (p.strip() for p in item.partition("="))
        slots[name] = slots[value] if value else nxt
        nxt = slots[name] + 1
    kinds = [k.strip() for k in re.search(r"enum E2Kind \{(.*?)\};", text,
                                          re.S).group(1).split(",")]
    rows = [(kinds.index(k), slots[d], slots[a], slots[b], int(s), int(v))
            for k, d, a, b, s, v in re.findall(
                r"\{(E2_\w+), (E2_\w+), (E2_\w+), (E2_\w+), (\d+), (\d+)\}",
                text)]
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\n",
                                                text)}
    if defines["E2_NTEMP"] != slots["E2_NSLOT"] - slots["E2_P0"]:
        raise ValueError("E2_NTEMP does not count the working slots")
    return slots, kinds, rows, defines


def temps() -> int:
    """Working slots of one addition."""
    return schedule()[3]["E2_NTEMP"]


def layout(inputs, out, temp) -> dict:
    """An addition's slots among its element's: the six input coordinates,
    the three of the sum, and its working slots from ``temp``; every
    element holds a and 3b in the header's E2_EL_A and E2_EL_B3."""
    d = schedule()[3]
    return {"in": tuple(inputs), "out": tuple(out), "a": d["E2_EL_A"],
            "b3": d["E2_EL_B3"], "temp": temp}


def place(s: int, m: dict) -> int:
    """A schedule slot among the element's slots."""
    slots = schedule()[0]
    if s < slots["E2_X3"]:
        return m["in"][s]
    if s < slots["E2_A"]:
        return m["out"][s - slots["E2_X3"]]
    if s == slots["E2_A"]:
        return m["a"]
    if s == slots["E2_B3"]:
        return m["b3"]
    return m["temp"] + s - slots["E2_P0"]


def build(G: int, maps) -> list:
    """The rows of one mode, which runs the additions ``maps`` in the same
    stages, for groups of G lanes: per stage (each lane's rows (kind, dst,
    a, b), product rounds)."""
    _, kinds, rows, defines = schedule()
    mul = kinds.index("E2_MUL")
    prog = []
    for s in range(defines["E2_NSTAGE"]):
        width = 1 + max(r[5] for r in rows if r[4] == s)
        lanes = [[] for _ in range(G)]
        for j, m in enumerate(maps):
            for kind, d, a, b, stage, v in rows:
                if stage == s:
                    lanes[(v + j * width) % G].append(
                        (kind, place(d, m), place(a, m), place(b, m)))
        prog.append((lanes, max(sum(r[0] == mul for r in lane)
                                for lane in lanes)))
    return prog


def modes(kernel: str) -> tuple:
    """The additions of each mode of ``kernel``'s program, on the element
    layouts of the header: K2's mode 1 is P + Q into P; K3's mode holds
    acc + base into acc where K3_MODE_ADD is set and base + base into base
    where K3_MODE_DBL is, the second addition's working slots after the
    first's."""
    d = schedule()[3]

    def point(s):
        return tuple(range(d[s], d[s] + 3))

    temp, ntemp = d["E2_EL_TEMP"], d["E2_NTEMP"]
    if kernel == "e2_add":
        P, Q = point("K2_P"), point("K2_Q")
        return ((), (layout(P + Q, P, temp),))
    acc, base = point("K3_ACC"), point("K3_BASE")
    out = []
    for mode in range(d["K3_MODE_ADD"] + d["K3_MODE_DBL"] + 1):
        maps = []
        if mode & d["K3_MODE_ADD"]:
            maps.append(layout(acc + base, acc, temp))
        if mode & d["K3_MODE_DBL"]:
            maps.append(layout(base + base, base, temp + len(maps) * ntemp))
        out.append(tuple(maps))
    return tuple(out)


def pack(G: int, modes) -> np.ndarray:
    """The E2Prog bytes of csrc/e2.cuh for groups of G lanes: op[E2_MAXOPS
    + 1] uint32 (kind | dst << 8 | a << 16 | b << 24), start[E2_MODES]
    [E2_NSTAGE][E2_MAXG + 1] uint16 (lane l's rows are [start[l],
    start[l + 1])), rounds[E2_MODES][E2_NSTAGE] uint8, zero-padded to a
    multiple of 16 bytes."""
    d = schedule()[3]
    nmodes, nstage, maxg, maxops = (d[k] for k in (
        "E2_MODES", "E2_NSTAGE", "E2_MAXG", "E2_MAXOPS"))
    if not 1 <= G <= maxg or len(modes) > nmodes:
        raise ValueError(f"no program for {G} lanes and {len(modes)} modes")
    op = np.zeros(maxops + 1, np.uint32)
    start = np.zeros((nmodes, nstage, maxg + 1), np.uint16)
    rounds = np.zeros((nmodes, nstage), np.uint8)
    k = 0
    for mode, maps in enumerate(modes):
        for s, (lanes, r) in enumerate(build(G, maps)):
            rounds[mode, s] = r
            for lane in range(maxg + 1):
                start[mode, s, lane] = k
                for kind, dst, a, b in (lanes[lane] if lane < G else ()):
                    if k == maxops:
                        raise ValueError("E2_MAXOPS is too small")
                    op[k] = kind | dst << 8 | a << 16 | b << 24
                    k += 1
    blob = op.tobytes() + start.tobytes() + rounds.tobytes()
    blob += bytes(-len(blob) % 16)
    return np.frombuffer(blob, np.uint8)


_PROGRAMS: dict = {}


def program(kernel: str, G: int, device) -> torch.Tensor:
    """The program of ``kernel`` ("e2_add" or "e2_scalar_mul") for groups
    of G lanes, as a uint8 tensor on ``device``, made once per device."""
    key = (kernel, G, str(device))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = torch.from_numpy(pack(G, modes(kernel)).copy()).to(
            device)
    return _PROGRAMS[key]
