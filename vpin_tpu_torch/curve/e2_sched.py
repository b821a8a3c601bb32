"""The programs of the group kernels, laid out from their stage schedules:
K2 and K3 from csrc/e2_sched.cuh (one complete addition on E2), K5 from
csrc/ed_sched.cuh (one unified addition on ristretto255).

Each header holds one addition as a table of field operations (kind,
destination slot, operand slots, stage, virtual lane).  ``program`` lays it
out for groups of G lanes as the GroupProg of csrc/e2.cuh: per mode (the set
of additions an element runs) and per stage, each lane's rows with their
slots resolved for the kernel's element layout, and the number of product
rounds; the wrappers pass it to the kernels, which copy it into shared
memory.  Virtual lane v of the j-th addition of a mode runs on lane
(v + j * width) % G, width being the stage's largest virtual lane + 1, each
lane's rows in table order.  A row whose destination is a shared slot (K5's
2d T2: the additions of a mode take the same second point) runs once per
mode, on the first addition's lane.
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADER = CSRC / "e2_sched.cuh"
ED_HEADER = CSRC / "ed_sched.cuh"

#: kernel -> the header of its schedule
HEADERS = {"e2_add": HEADER, "e2_scalar_mul": HEADER, "ed_ladder": ED_HEADER}


def _text(header: Path) -> str:
    return re.sub(r"//[^\n]*", "", header.read_text())


def _prefix(header: Path = HEADER) -> str:
    """The header's name prefix: "E2" or "ED"."""
    return re.search(r"enum (\w+)Slot \{", _text(header)).group(1).upper()


@lru_cache(maxsize=None)
def schedule(header: Path = HEADER):
    """-> (slots {name: index}, kinds [name], rows [(kind, dst, a, b,
    stage, lane)], defines {name: int}) as ``header`` states them; the
    kinds are e2_sched.cuh's, whose row format every schedule shares."""
    text = _text(header)
    slots, nxt = {}, 0
    body = re.search(r"enum \w+Slot \{(.*?)\};", text, re.S).group(1)
    for item in filter(None, (t.strip() for t in body.split(","))):
        name, _, value = (p.strip() for p in item.partition("="))
        slots[name] = slots[value] if value else nxt
        nxt = slots[name] + 1
    kinds = [k.strip() for k in re.search(
        r"enum E2Kind \{(.*?)\};", _text(HEADER), re.S).group(1).split(",")]
    rows = [(kinds.index(k), slots[d], slots[a], slots[b], int(s), int(v))
            for k, d, a, b, s, v in re.findall(
                r"\{(E2_(?:MUL|ADD|SUB)), (\w+), (\w+), (\w+), (\d+), (\d+)\}",
                text)]
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\n",
                                                text)}
    p = _prefix(header)
    if defines[f"{p}_NTEMP"] != slots[f"{p}_NSLOT"] - slots[f"{p}_P0"]:
        raise ValueError(f"{p}_NTEMP does not count the working slots")
    return slots, kinds, rows, defines


def temps(header: Path = HEADER) -> int:
    """Working slots of one addition."""
    return schedule(header)[3][f"{_prefix(header)}_NTEMP"]


def _layout(header, inputs, out, consts, temp, shared=()) -> dict:
    """An addition's slots among its element's: the schedule's slots in enum
    order are the inputs, the sum's coordinates, the constants (and shared
    values), then the working slots from ``temp``."""
    slots, _, _, _ = schedule(header)
    p = _prefix(header)
    table = (tuple(inputs) + tuple(out) + tuple(consts)
             + tuple(range(temp, temp + temps(header))))
    if len(table) != slots[f"{p}_NSLOT"]:
        raise ValueError(f"{p}: {len(table)} slots mapped, not "
                         f"{slots[f'{p}_NSLOT']}")
    return {"in": tuple(inputs), "out": tuple(out), "slots": table,
            "shared": frozenset(slots[s] for s in shared)}


def layout(inputs, out, temp) -> dict:
    """An E2 addition's slots among its element's: the six input
    coordinates, the three of the sum, and its working slots from ``temp``;
    every element holds a and 3b in the header's E2_EL_A and E2_EL_B3."""
    d = schedule()[3]
    return _layout(HEADER, inputs, out, (d["E2_EL_A"], d["E2_EL_B3"]), temp)


def ed_layout(inputs, out, temp) -> dict:
    """A ristretto255 addition's slots among its element's: the eight input
    coordinates, the four of the sum, and its working slots from ``temp``;
    every element holds 2d and the shared 2d T2 in ED_EL_D2 and ED_EL_DT2."""
    d = schedule(ED_HEADER)[3]
    return _layout(ED_HEADER, inputs, out, (d["ED_EL_D2"], d["ED_EL_DT2"]),
                   temp, shared=("ED_DT2",))


def build(G: int, maps, header: Path = HEADER) -> list:
    """The rows of one mode, which runs the additions ``maps`` in the same
    stages, for groups of G lanes: per stage (each lane's rows (kind, dst,
    a, b), product rounds)."""
    _, kinds, rows, defines = schedule(header)
    mul = kinds.index("E2_MUL")
    prog = []
    for s in range(defines[f"{_prefix(header)}_NSTAGE"]):
        width = 1 + max(r[5] for r in rows if r[4] == s)
        lanes = [[] for _ in range(G)]
        for j, m in enumerate(maps):
            for kind, d, a, b, stage, v in rows:
                if stage != s:
                    continue
                row = (kind, *(m["slots"][x] for x in (d, a, b)))
                if d in m["shared"] and j:
                    if row != (kind, *(maps[0]["slots"][x]
                                       for x in (d, a, b))):
                        raise ValueError("the additions of a mode do not "
                                         "share a shared row's operands")
                    continue
                lanes[(v + j * width) % G].append(row)
        prog.append((lanes, max(sum(r[0] == mul for r in lane)
                                for lane in lanes)))
    return prog


def modes(kernel: str) -> tuple:
    """The additions of each mode of ``kernel``'s program, on the element
    layouts of its header: K2's mode 1 is P + Q into P; K3's and K5's mode
    holds acc + base into acc where the ADD bit is set and base + base into
    base where the DBL bit is, the second addition's working slots after the
    first's."""
    if kernel == "e2_add":
        d = schedule()[3]
        P = tuple(range(d["K2_P"], d["K2_P"] + 3))
        Q = tuple(range(d["K2_Q"], d["K2_Q"] + 3))
        return ((), (layout(P + Q, P, d["E2_EL_TEMP"]),))
    if kernel == "e2_scalar_mul":
        d, k, coords, lay = schedule()[3], "K3", 3, layout
    elif kernel == "ed_ladder":
        d, k, coords, lay = schedule(ED_HEADER)[3], "K5", 4, ed_layout
    else:
        raise ValueError(f"no program for {kernel}")
    p = _prefix(HEADERS[kernel])
    temp, ntemp = d[f"{p}_EL_TEMP"], d[f"{p}_NTEMP"]
    acc = tuple(range(d[f"{k}_ACC"], d[f"{k}_ACC"] + coords))
    base = tuple(range(d[f"{k}_BASE"], d[f"{k}_BASE"] + coords))
    add, dbl = d[f"{k}_MODE_ADD"], d[f"{k}_MODE_DBL"]
    out = []
    for mode in range(add + dbl + 1):
        maps = []
        if mode & add:
            maps.append(lay(acc + base, acc, temp))
        if mode & dbl:
            maps.append(lay(base + base, base, temp + len(maps) * ntemp))
        out.append(tuple(maps))
    return tuple(out)


def pack(G: int, modes, header: Path = HEADER) -> np.ndarray:
    """The GroupProg bytes of csrc/e2.cuh for groups of G lanes, with the
    sizes ``header`` defines (P: its prefix): op[P_MAXOPS + 1] uint32 (kind
    | dst << 8 | a << 16 | b << 24), start[P_MODES][P_NSTAGE][E2_MAXG + 1]
    uint16 (lane l's rows are [start[l], start[l + 1])), rounds[P_MODES]
    [P_NSTAGE] uint8, zero-padded to a multiple of 16 bytes."""
    d, p = schedule(header)[3], _prefix(header)
    nmodes, nstage, maxops = (d[f"{p}_{k}"] for k in (
        "MODES", "NSTAGE", "MAXOPS"))
    maxg = schedule()[3]["E2_MAXG"]
    if not 1 <= G <= maxg or len(modes) > nmodes:
        raise ValueError(f"no program for {G} lanes and {len(modes)} modes")
    op = np.zeros(maxops + 1, np.uint32)
    start = np.zeros((nmodes, nstage, maxg + 1), np.uint16)
    rounds = np.zeros((nmodes, nstage), np.uint8)
    k = 0
    for mode, maps in enumerate(modes):
        for s, (lanes, r) in enumerate(build(G, maps, header)):
            rounds[mode, s] = r
            for lane in range(maxg + 1):
                start[mode, s, lane] = k
                for kind, dst, a, b in (lanes[lane] if lane < G else ()):
                    if k == maxops:
                        raise ValueError(f"{p}_MAXOPS is too small")
                    op[k] = kind | dst << 8 | a << 16 | b << 24
                    k += 1
    blob = op.tobytes() + start.tobytes() + rounds.tobytes()
    blob += bytes(-len(blob) % 16)
    return np.frombuffer(blob, np.uint8)


_PROGRAMS: dict = {}


def program(kernel: str, G: int, device) -> torch.Tensor:
    """The program of ``kernel`` ("e2_add", "e2_scalar_mul" or "ed_ladder")
    for groups of G lanes, as a uint8 tensor on ``device``, made once per
    device."""
    key = (kernel, G, str(device))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = torch.from_numpy(pack(
            G, modes(kernel), HEADERS[kernel]).copy()).to(device)
    return _PROGRAMS[key]
