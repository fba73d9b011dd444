"""GSM 06.10 full-rate vocoder bit ordering (GSM 05.03 Table 2).

The TCH/FS channel coder does not protect vocoder bits in payload order:
GSM 05.03 Table 2 sorts the 260 bits of a GSM 06.10 frame by subjective
importance (class 1a/1b/2). `BIT_ORDER[k]` is the RTP-payload bit index
of coder bit d[k] (reference: `GSM/GSM610Tables.{h,cpp}`, numeric values
of the standard table).
"""

import numpy as np

BIT_ORDER = np.array([
    0, 47, 103, 159, 215, 1, 6, 12, 2, 7, 13, 17, 36, 92, 148, 204, 48,
    104, 160, 216, 8, 22, 26, 37, 93, 149, 205, 38, 94, 150, 206, 39, 95,
    151, 207, 40, 96, 152, 208, 49, 105, 161, 217, 3, 18, 30, 41, 97, 153,
    209, 23, 27, 43, 99, 155, 211, 42, 98, 154, 210, 45, 101, 157, 213, 4,
    9, 14, 33, 19, 24, 31, 44, 100, 156, 212, 50, 106, 162, 218, 53, 56,
    59, 62, 65, 68, 71, 74, 77, 80, 83, 86, 89, 109, 112, 115, 118, 121,
    124, 127, 130, 133, 136, 139, 142, 145, 165, 168, 171, 174, 177, 180,
    183, 186, 189, 192, 195, 198, 201, 221, 224, 227, 230, 233, 236, 239,
    242, 245, 248, 251, 254, 257, 46, 102, 158, 214, 51, 107, 163, 219,
    54, 57, 60, 63, 66, 69, 72, 75, 78, 81, 84, 87, 90, 110, 113, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 166, 169, 172, 175,
    178, 181, 184, 187, 190, 193, 196, 199, 202, 222, 225, 228, 231, 234,
    237, 240, 243, 246, 249, 252, 255, 258, 5, 10, 15, 28, 32, 34, 35, 16,
    20, 21, 25, 52, 108, 164, 220, 55, 58, 61, 64, 67, 70, 73, 76, 79, 82,
    85, 88, 91, 111, 114, 117, 120, 123, 126, 129, 132, 135, 138, 141,
    144, 147, 167, 170, 173, 176, 179, 182, 185, 188, 191, 194, 197, 200,
    203, 223, 226, 229, 232, 235, 238, 241, 244, 247, 250, 253, 256, 259,
    11, 29,
], np.int32)

assert len(BIT_ORDER) == 260


def payload_to_coder(payload_bits):
    """RTP-payload order → coder (importance) order: d[k] = p[BIT_ORDER[k]]
    (BitVector::map with g610BitOrder)."""
    return np.asarray(payload_bits)[..., BIT_ORDER]


def coder_to_payload(coder_bits):
    """Coder order → RTP-payload order (BitVector::unmap)."""
    coder_bits = np.asarray(coder_bits)
    out = np.zeros_like(coder_bits)
    out[..., BIT_ORDER] = coder_bits
    return out
