"""Million rays a second: the rays of every unit the window completed
(H·W·spp·bounces·2, a closest-hit and a shadow ray a bounce) over the
window's seconds."""


def read(window):
    return sum(u["rays"] for u in window.units) / window.seconds / 1e6
