"""``sampler_images_per_s``: chain-images of every sampler step completed in
the window (chains x batch x steps), over the seconds from the window's
start to the wait for the card after its last step."""


def read(run):
    w = run.window
    if "epochs" not in w:
        return None
    return w["images"] / w["seconds"]
