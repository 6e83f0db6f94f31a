"""Pure-Python integer oracle for the CRUSH core primitives.

Bit-exact, scalar, slow.  This is the semantic ground truth the JAX path
and the C++ CPU reference are differentially tested against.  Semantics
follow the CRUSH spec recorded in SURVEY.md §2.1 (upstream layout:
``src/crush/hash.c :: crush_hash32_rjenkins1_{2,3}``,
``src/crush/mapper.c :: crush_ln / bucket_straw2_choose``,
``src/common/ceph_hash.cc :: ceph_str_hash_rjenkins``,
``src/include/rados.h :: ceph_stable_mod``).
"""

from __future__ import annotations

from ._crush_ln_tables import LL_TBL, RH_LH_TBL

M32 = 0xFFFFFFFF
CRUSH_HASH_SEED = 1315423911  # 0x4e67c6a7
S64_MIN = -(1 << 63)


def hashmix(a: int, b: int, c: int) -> tuple[int, int, int]:
    """One 9-line rjenkins mix round over wrapping u32."""
    a = (a - b - c) & M32
    a ^= c >> 13
    b = (b - c - a) & M32
    b = (b ^ (a << 8)) & M32
    c = (c - a - b) & M32
    c ^= b >> 13
    a = (a - b - c) & M32
    a ^= c >> 12
    b = (b - c - a) & M32
    b = (b ^ (a << 16)) & M32
    c = (c - a - b) & M32
    c ^= b >> 5
    a = (a - b - c) & M32
    a ^= c >> 3
    b = (b - c - a) & M32
    b = (b ^ (a << 10)) & M32
    c = (c - a - b) & M32
    c ^= b >> 15
    return a, b, c


def crush_hash32_2(a: int, b: int) -> int:
    a &= M32
    b &= M32
    h = (CRUSH_HASH_SEED ^ a ^ b) & M32
    x, y = 231232, 1232
    a, b, h = hashmix(a, b, h)
    x, a, h = hashmix(x, a, h)
    b, y, h = hashmix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= M32
    b &= M32
    c &= M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c) & M32
    x, y = 231232, 1232
    a, b, h = hashmix(a, b, h)
    c, x, h = hashmix(c, x, h)
    y, a, h = hashmix(y, a, h)
    b, x, h = hashmix(b, x, h)
    y, c, h = hashmix(y, c, h)
    return h


def ceph_str_hash_rjenkins(data: bytes) -> int:
    """rjenkins over a byte string (object-name -> placement seed)."""
    length = len(data)
    a = b = 0x9E3779B9
    c = 0
    k = 0
    n = length
    while n >= 12:
        a = (a + int.from_bytes(data[k : k + 4], "little")) & M32
        b = (b + int.from_bytes(data[k + 4 : k + 8], "little")) & M32
        c = (c + int.from_bytes(data[k + 8 : k + 12], "little")) & M32
        a, b, c = hashmix(a, b, c)
        k += 12
        n -= 12
    c = (c + length) & M32
    if n >= 11:
        c = (c + (data[k + 10] << 24)) & M32
    if n >= 10:
        c = (c + (data[k + 9] << 16)) & M32
    if n >= 9:
        c = (c + (data[k + 8] << 8)) & M32
    if n >= 8:
        b = (b + (data[k + 7] << 24)) & M32
    if n >= 7:
        b = (b + (data[k + 6] << 16)) & M32
    if n >= 6:
        b = (b + (data[k + 5] << 8)) & M32
    if n >= 5:
        b = (b + data[k + 4]) & M32
    if n >= 4:
        a = (a + (data[k + 3] << 24)) & M32
    if n >= 3:
        a = (a + (data[k + 2] << 16)) & M32
    if n >= 2:
        a = (a + (data[k + 1] << 8)) & M32
    if n >= 1:
        a = (a + data[k]) & M32
    a, b, c = hashmix(a, b, c)
    return c


def ceph_str_hash_linux(data: bytes) -> int:
    """Linux dcache string hash (reference ``ceph_str_hash_linux``,
    ``src/common/ceph_hash.cc``): the alternate ``object_hash``
    selectable per pool (CEPH_STR_HASH_LINUX)."""
    h = 0
    for byte in data:
        h = (h + (byte << 4) + (byte >> 4)) * 11 & M32
    return h


# reference src/include/rados.h values — LINUX is 0x1, RJENKINS 0x2
CEPH_STR_HASH_LINUX = 1
CEPH_STR_HASH_RJENKINS = 2


def ceph_str_hash(alg: int, data: bytes) -> int:
    """Dispatch by pool ``object_hash`` id (reference ``ceph_str_hash``)."""
    if alg == CEPH_STR_HASH_LINUX:
        return ceph_str_hash_linux(data)
    if alg == CEPH_STR_HASH_RJENKINS:
        return ceph_str_hash_rjenkins(data)
    raise ValueError(f"unknown object_hash {alg}")


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Split-friendly bucketing for non-power-of-two moduli."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def pg_num_mask(pg_num: int) -> int:
    """Smallest 2^k - 1 >= pg_num - 1 (upstream calc_pg_masks semantics)."""
    return (1 << (pg_num - 1).bit_length()) - 1 if pg_num > 1 else 0


def crush_ln(xin: int) -> int:
    """~ 2^44 * log2(xin + 1) for xin in [0, 0xffff]; 48-bit fixed point."""
    x = xin + 1
    iexpon = 15
    if not (x & 0x18000):
        p = x.bit_length() - 1  # position of the highest set bit
        bits = 15 - p
        x <<= bits
        iexpon = p
    index1 = (x >> 8) << 1
    rh = RH_LH_TBL[index1 - 256]
    lh = RH_LH_TBL[index1 + 1 - 256]
    xl64 = (x * rh) >> 48
    index2 = xl64 & 0xFF
    ll = LL_TBL[index2]
    return (iexpon << 44) + ((lh + ll) >> 4)


def straw2_draw(x: int, item_id: int, r: int, weight: int) -> int:
    """Signed straw2 draw for one item.  weight is 16.16 fixed point u32."""
    if weight == 0:
        return S64_MIN
    u = crush_hash32_3(x, item_id, r) & 0xFFFF
    ln = crush_ln(u) - (1 << 48)  # <= 0
    # div64_s64 truncates toward zero; ln <= 0, weight > 0.
    return -((-ln) // weight)


def bucket_straw2_choose(
    item_ids: list[int], weights: list[int], x: int, r: int
) -> int:
    """Index (not id) of the straw2 winner; ties -> first index."""
    high = 0
    high_draw = 0
    for i, (iid, w) in enumerate(zip(item_ids, weights)):
        draw = straw2_draw(x, iid, r, w)
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return high


def is_out(weight_osd: int, item: int, x: int) -> bool:
    """Reweight rejection test; weight_osd is the 16.16 per-OSD reweight."""
    if weight_osd >= 0x10000:
        return False
    if weight_osd == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= weight_osd
