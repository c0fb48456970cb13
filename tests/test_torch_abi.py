"""The port's ctypes mirror of the C API (pccl_tpu_torch/comm/_native.py)
against pccl_tpu/native/include/pcclt.h.

Both are read with the repository's ABI checker's parsers
(tools/pcclt_check/abi.py: parse_header, parse_native; the source is never
imported, so no library is needed). The port declares a subset of the
header: every struct it mirrors must match its header struct field by
field in name, order and width, and every function it declares must exist
in the header with the same restype and argtypes. A header export the port
does not call is no finding. The negative cases change one declaration in
a copy of the port's source and require the diff to flag it.
"""

from pathlib import Path

import pytest

from tools.pcclt_check import abi

REPO = Path(__file__).resolve().parent.parent
HEADER = REPO / "pccl_tpu" / "native" / "include" / "pcclt.h"
PORT = REPO / "pccl_tpu_torch" / "comm" / "_native.py"


def _diff(header_text: str, native_text: str) -> list:
    """Every way the declarations of `native_text` differ from the header."""
    hm, pm = abi.parse_header(header_text), abi.parse_native(native_text)
    py_structs = set(pm.structs)
    by_norm = {abi._norm(name): name for name in hm.structs}
    out = []
    for pyname, pfields in pm.structs.items():
        cname = by_norm.get(abi._norm(pyname))
        if cname is None:
            out.append(f"{pyname}: no struct of that name in pcclt.h")
            continue
        cfields = hm.structs[cname]
        if [f[0] for f in pfields] != [f[0] for f in cfields]:
            out.append(f"{pyname}: fields {[f[0] for f in pfields]}, {cname} has "
                       f"{[f[0] for f in cfields]}")
            continue
        for (fname, ctype, _), (_, ptype, _) in zip(cfields, pfields):
            if not abi._compatible(ctype, ptype, py_structs):
                out.append(f"{pyname}.{fname}: {ptype}, pcclt.h {ctype}")
    for fname, entry in pm.funcs.items():
        if fname not in hm.funcs:
            out.append(f"{fname}: not exported by pcclt.h")
            continue
        ret, cargs, _ = hm.funcs[fname]
        if not abi._compatible(ret, entry.get("restype", "c_int"), py_structs):
            out.append(f"{fname}.restype: {entry.get('restype')}, pcclt.h {ret}")
        pargs = entry.get("argtypes")
        if pargs is None:
            if cargs:
                out.append(f"{fname}: no argtypes, pcclt.h has {len(cargs)}")
        elif len(pargs) != len(cargs) or not all(
                abi._compatible(c, p, py_structs) for c, p in zip(cargs, pargs)):
            out.append(f"{fname}.argtypes: {pargs}, pcclt.h {cargs}")
    return out


def test_port_mirror_matches_the_header():
    native = PORT.read_text()
    pm = abi.parse_native(native)
    # the parser found what the port declares, so an empty diff means
    # something
    assert len(pm.structs) >= 8 and len(pm.funcs) >= 37, (
        sorted(pm.structs), sorted(pm.funcs))
    assert all(fields for fields in pm.structs.values())
    assert all("argtypes" in e or "restype" in e for e in pm.funcs.values())
    assert _diff(HEADER.read_text(), native) == []


# (what is changed, the port's line as it is, the same line changed, a word
# the finding must name)
MUTATIONS = {
    "field width": ('("master_port", ctypes.c_uint16)',
                    '("master_port", ctypes.c_uint32)', "master_port"),
    "field order": ('("tx_bytes", ctypes.c_uint64),\n        ("rx_bytes", ctypes.c_uint64)',
                    '("rx_bytes", ctypes.c_uint64),\n        ("tx_bytes", ctypes.c_uint64)',
                    "ReduceInfo"),
    "argument width": ("lib.pccltCreateMaster.argtypes = [c.c_char_p, c.c_uint16,",
                       "lib.pccltCreateMaster.argtypes = [c.c_char_p, c.c_uint32,",
                       "pccltCreateMaster"),
    "return type": ("lib.pccltMasterPort.restype = c.c_uint16",
                    "lib.pccltMasterPort.restype = c.c_int", "pccltMasterPort"),
    "unknown function": ("lib.pccltMasterPort.", "lib.pccltMasterPortX.",
                         "pccltMasterPortX"),
}


@pytest.mark.parametrize("change", sorted(MUTATIONS))
def test_a_changed_declaration_is_flagged(change):
    old, new, word = MUTATIONS[change]
    native = PORT.read_text()
    assert native.count(old) >= 1, f"the port no longer has {old!r}"
    found = _diff(HEADER.read_text(), native.replace(old, new, 1))
    assert found and any(word in f for f in found), found
