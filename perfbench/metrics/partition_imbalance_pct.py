"""How far the fullest rank's share of the window's records lies over
the mean share, in %: ``100 * (max_r n_r / mean_r n_r - 1)``, ``n_r`` the
records in rank ``r``'s answers (its ``n_valid``) summed over the
window.  The learned routing's equi-depth claim, under the file's skew."""


def read(ctx):
    n = [r.n_valid for r in getattr(ctx, "ranks", [])]
    if not n or not sum(n):
        return None
    return 100.0 * (max(n) / (sum(n) / len(n)) - 1.0)
