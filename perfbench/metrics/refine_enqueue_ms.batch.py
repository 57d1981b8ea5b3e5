"""Host enqueue of one batch's ``refine_2d``: the program's span
``refine_2d`` (``utils.spans``, recorded in ``--trace 1`` runs), mean
over the window's untraced batches, in ms.  None where the program
records no such span."""


def read(run):
    xs = run.spans.get("refine_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
