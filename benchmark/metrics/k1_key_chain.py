"""k1_key_chain: the longest serial chain of K1's key sum a tile, mean over
the tiles of a restart (``ops/em_bdr.py::key_census``: the most marginals
one lane sums one after another, over the warps), as the client recorded
it at set-up on the training rows; in marginals.  None where the client
recorded no census."""


def read(run):
    chains = [it["key_chain"] for it in run.items if "key_chain" in it]
    return chains[0] if chains else None
