from kaolin_tpu.render.mesh.rasterization import (  # noqa: F401
    rasterize, rasterize_selection)
from kaolin_tpu.render.mesh.dibr import (  # noqa: F401
    dibr_soft_mask, dibr_soft_mask_select, dibr_rasterization)
from kaolin_tpu.render.mesh._fused import (  # noqa: F401
    FusedSelection, fused_selection, softmask_fused)
from kaolin_tpu.render.mesh.deftet import deftet_sparse_render  # noqa: F401
from kaolin_tpu.render.mesh.utils import (  # noqa: F401
    texture_mapping, spherical_harmonic_lighting, prepare_vertices)
