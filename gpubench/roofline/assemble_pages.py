"""assemble_pages: a paged stack's words from its dense and encoded
pages, in one launch."""

KERNEL = "assemble_pages"
SYMBOLS = ("assemble_pages_kernel",)


def _payload_bytes(page, lanes: int, w: int) -> int:
    if hasattr(page, "shape"):                 # a dense page
        return min(page.shape[0], lanes) * w * 4
    return sum(t.numel() * t.element_size()
               for t in (getattr(page, k, None)
                         for k in ("coords", "run_starts", "run_lens"))
               if t is not None)


def cost(pages, shape, page_lanes, table=None):
    w = int(shape[-1])
    lanes = 1
    for d in shape[:-1]:
        lanes *= int(d)
    read = 0
    left = lanes
    for page in pages:
        read += _payload_bytes(page, left, w)
        left -= page_lanes
    # each page's payload read once, every lane written once
    return {"bytes": read + lanes * w * 4}


WRAPPERS = {"assemble_pages": cost}
