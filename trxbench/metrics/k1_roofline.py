"""K1's share of its roofline, %: the least time the card could take for
each resampler launch in the traced stretch, at its own shape
(`trxbench/roofline.py`), summed, over the launches' device time. None
where the stretch holds no launch, the card's peaks are not in the
table, or the launches the profiler saw and the shapes the program was
called with do not pair up."""

from trxbench import roofline


def read(rec: dict):
    st = rec.get("stretch")
    peaks = rec.get("peaks")
    if not st or not st["k1"] or not peaks:
        return None
    shapes = rec.get("k1_stretch_shapes", [])
    if len(shapes) != len(st["k1"]):
        return None
    bound = sum(roofline.bound_s(*roofline.k1_work(*s), peaks)
                for s in shapes)
    return 100.0 * bound / sum(t for _, t in st["k1"])
