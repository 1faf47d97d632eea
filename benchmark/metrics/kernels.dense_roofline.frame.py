"""``kernels.dense_roofline.frame``: the dense K1/K2's (``march_dense_kernel``
in ``csrc/march.cu``) share of the float32 roofline, in %: the
operations their lane-steps needed over the H100's published 67 TFLOP/s
(SXM, 700 W, outside the tensor cores), over their device time a frame.

Operations: ``dense.lane_steps.frame`` × the operations of one evaluation
of the scene's distance, counted from the configuration by the functions
below, one a leaf kind and one a combine, term by term from the
distances of ``csrc/ft_sdf.cuh``: an add, subtract, multiply, divide,
square root, min, max or compare is one, a fused multiply-add two (its
multiply and its add), an absolute value or a negation none (operand
modifiers).  Bytes do not bound it: a block stages the program and reads
the rows it cannot stage as broadcasts from cache."""

PEAK_FLOPS = 67e12
KERNEL = "march_dense_kernel"


def sphere_ops() -> int:
    # p - c (3), |.|² (3 mul, 2 add), + 1e-20, sqrt, - r
    return 3 + 5 + 1 + 1 + 1


def box_ops() -> int:
    # |p - c| - h (3 + 3), max(q, 0) (3), |o|² + 1e-20 (6), sqrt,
    # max(max(qx, qy), qz) (2), min(., 0), outside + inside, - r
    return 6 + 3 + 6 + 1 + 2 + 1 + 1 + 1


def cone_ops() -> int:
    ba = 3 + 1                     # b - a, rb - ra
    baba = 5 + 1                   # |b - a|², max(., 1e-20)
    pa = 3 + 5                     # p - a, |p - a|²
    paba = 5 + 1                   # (p - a)·(b - a), / baba
    x = 2 + 1 + 1 + 1              # paba² baba, papa - ., max, sqrt
    cax = 1 + 1 + 1                # paba < 0.5, x - r, max(., 0)
    cay = 2                        # |paba - 0.5| - 0.5
    k = 2                          # rba² + baba
    f = 1 + 1 + 1 + 1 + 1 + 2      # x - ra, rba ·, paba baba, +, /, clamp
    cb = 3 + 1                     # x - ra - f rba, paba - f
    s = 2                          # cbx < 0, cay < 0
    tail = 4 + 4 + 1 + 1 + 1 + 1   # two squared lengths, min, + 1e-20,
    #                                sqrt, s ·
    return ba + baba + pa + paba + x + cax + cay + k + f + cb + s + tail


def fold_ops(n: int) -> int:
    """A min or max of ``n`` values (a group or a union / intersect)."""
    return n - 1


def subtract_ops() -> int:
    return 1                       # max(a, -b)


LEAF_OPS = {"sphere": sphere_ops, "box": box_ops, "cone": cone_ops}


def evaluation_ops(config: dict) -> int:
    """Operations of one evaluation of the parts scene: each part's box,
    sphere and three drills, its max, drill min and subtract; the union
    over the parts; the clip sphere and its intersect; the cut sphere and
    its subtract."""
    n = int(config["scene"]["n_parts"])
    part = (box_ops() + sphere_ops() + 3 * cone_ops() + fold_ops(2)
            + fold_ops(3) + subtract_ops())
    return (n * part + fold_ops(n) + sphere_ops() + fold_ops(2)
            + sphere_ops() + subtract_ops())


def _base(name):
    return name.split("(")[0].replace("void ", "").split("<")[0].strip()


def read(run):
    dense = getattr(run, "dense", None)
    if run.tr is None or not dense or not run.completed:
        return None
    ms = run.tr.ms(lambda n: _base(n) == KERNEL)
    if ms <= 0:
        return None
    bound_s = dense["lane_steps"] * evaluation_ops(run.config) / PEAK_FLOPS
    return 100.0 * bound_s / (ms * 1e-3)
