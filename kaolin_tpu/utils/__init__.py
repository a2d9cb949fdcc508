from kaolin_tpu.utils import testing  # noqa: F401
from kaolin_tpu.utils import profiler  # noqa: F401
from kaolin_tpu.utils.compile_cache import enable_compile_cache  # noqa: F401
