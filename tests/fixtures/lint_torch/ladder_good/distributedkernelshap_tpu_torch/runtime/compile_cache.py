"""Mini compile cache: the one signature spelling."""


def shape_signature(rows, path=None):
    sig = f"rows={int(rows)}"
    if path:
        sig = f"{sig},path={path}"
    return sig
