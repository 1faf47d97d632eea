"""``dense.lane_steps.frame``: the scene evaluations the dense K1/K2 made a
frame (a lane's march step each, the steps the root-bound skip spared
left out), counted on the device by the kernel (one atomic add a warp)
and read through ``ops.cuda.dense_counts()`` after the warm-up and after
the window (``traffic/parts_frame.py``). Nothing where the port keeps no
such counter."""


def read(run):
    dense = getattr(run, "dense", None)
    if not dense or not run.completed:
        return None
    return dense["lane_steps"] / run.completed
