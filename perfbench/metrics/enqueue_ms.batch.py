"""Host enqueue of one batch: the host clock from the call of the
program's detect to its return (no sync inside), mean over the window's
untraced batches, in ms."""


def read(run):
    xs = run.spans.get("enqueue_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
