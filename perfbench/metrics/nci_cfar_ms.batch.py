"""Host enqueue of one batch's NCI CFAR: the program's span ``nci.cfar``
(``utils.spans``, recorded in ``--trace 1`` runs: the integration-matched
configuration and the CFAR launch of ``detect_integrated``), mean over
the window's untraced batches, in ms.  None where the program records no
such span."""


def read(run):
    xs = run.spans.get("nci_cfar_s")
    return 1e3 * sum(xs) / len(xs) if xs else None
