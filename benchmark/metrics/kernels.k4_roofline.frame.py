"""``kernels.k4_roofline.frame``: K4's (``csrc/gather.cu``, the block
gather of the wavefront queue's compactions) share of its roofline, in %:
the least time the card could take, bytes from the shapes over the H100's
published 3.35 TB/s (SXM, 700 W), over K4's device time per frame.

Bytes a frame, from the configuration's shapes alone: each compaction
moves the queue's capacity C = width · height · bins lanes, 48 bytes a
lane (origin and direction 3 × 4 bytes each; pixel, bin, throughput,
budget, and the two flags gathered as 4-byte words), read once and
written once, plus one 4-byte block index a field per 1024-lane block;
a frame compacts ``depth − 1`` times (after the primary round and after
every bounce round but the last).  Operations are nil: the bound is
bytes."""

PEAK_BYTES_S = 3.35e12
LANE_BYTES = 48
FIELDS = 8
BLOCK = 1024


def bytes_per_frame(wave):
    lanes = int(wave["width"]) * int(wave["height"]) * int(wave["num_bins"])
    per = 2 * lanes * LANE_BYTES + FIELDS * (lanes // BLOCK) * 4
    return (int(wave["depth"]) - 1) * per


def _base(name):
    return name.split("(")[0].replace("void ", "").split("<")[0].strip()


def read(run):
    if run.tr is None or not run.completed:
        return None
    ms = run.tr.ms(lambda n: _base(n) == "block_gather_kernel")
    if ms <= 0:
        return None
    bound_s = bytes_per_frame(run.config["wavefront"]) / PEAK_BYTES_S
    return 100.0 * bound_s / (ms * 1e-3 / run.completed)
