from kaolin_tpu.render.spc.raytrace import (  # noqa: F401
    RaytraceInfo, unbatched_raytrace, mark_pack_boundaries,
    mark_first_hit, diff, sum_reduce, cumsum, cumprod,
    exponential_integration)
from kaolin_tpu.render.spc.raygen import (  # noqa: F401
    generate_primary_rays, generate_shadow_rays)
from kaolin_tpu.render.spc.raster import (  # noqa: F401
    CoherentHits, unbatched_raytrace_coherent, hits_to_nuggets)
