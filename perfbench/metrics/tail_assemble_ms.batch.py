"""Host enqueue of one batch's maps-path assembly: the program's span
``tail.assemble`` (``utils.spans``, recorded in ``--trace 1`` runs: the
sub-bin interpolation, physics and AoA of ``assemble_result``), mean
over the window's untraced batches, in ms.  None where the program
records no such span."""


def read(run):
    xs = run.spans.get("tail_assemble_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
