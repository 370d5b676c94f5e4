"""Import every assigned architecture config (populates the registry)."""

import repro_torch.configs.qwen2_5_3b  # noqa: F401
import repro_torch.configs.gemma_7b  # noqa: F401
import repro_torch.configs.qwen3_8b  # noqa: F401
import repro_torch.configs.gemma2_27b  # noqa: F401
import repro_torch.configs.pixtral_12b  # noqa: F401
import repro_torch.configs.hubert_xlarge  # noqa: F401
import repro_torch.configs.mamba2_370m  # noqa: F401
import repro_torch.configs.moonshot_v1_16b_a3b  # noqa: F401
import repro_torch.configs.deepseek_v3_671b  # noqa: F401
import repro_torch.configs.zamba2_1_2b  # noqa: F401
