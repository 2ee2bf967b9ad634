"""Images trained in the window over the window's seconds (host clock, the
window closed by a synchronise after the last epoch's losses were read)."""


def read(run):
    if run.get("unprofiled") is not None or not run["seconds"]:
        return None
    return run["images"] / run["seconds"]
