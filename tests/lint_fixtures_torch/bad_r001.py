"""R001 fixture (port forms): StateArrays column writes, by subscript and
by in-place tensor methods, with no mark_dirty pairing."""
import torch


def credit(state, ids, amount):
    state.balances[ids] += amount                        # subscript store
    state.submissions.index_add_(0, ids, torch.ones_like(ids))  # in place
    col = getattr(state, "stake")
    col.copy_(torch.zeros_like(col))                     # via an alias
    return state
