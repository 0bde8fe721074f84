"""``bma_images_per_s``: test images scored through every member of the
ensemble in the window, over the window's seconds."""


def read(run):
    w = run.window
    if "members" not in w:
        return None
    return w["images"] / w["seconds"]
