"""Upload rate of the ingest: bytes of the streamer's pinned-to-device
copies in the traced window over their summed device time, in GB/s."""


def read(run):
    data = run.profile.data if run.profile else None
    if not data or not data.get("h2d_copies") or not data["h2d_s"]:
        return None
    nbytes = data["h2d_copies"] * run.spans["upload_bytes"][0]
    return nbytes / data["h2d_s"] / 1e9
