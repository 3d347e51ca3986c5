"""Wire-protocol range this build speaks.

The port has no delta publisher yet; it keeps the reference's protocol
range because every exposition states it (``kts_build_info``'s
``proto_min``/``proto_max`` labels), so a scrape-side version census reads
the port's nodes like the reference's.
"""

PROTO_MIN = 1
PROTO_MAX = 2
