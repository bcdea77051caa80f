"""xLSTM-350M [arXiv:2405.04517]: mLSTM blocks with 1-in-6 sLSTM
(xLSTM[m:s] mix), block-internal expansion (proj factor 2) — d_ff=0
per the assignment: blocks carry their own FFN-equivalent."""
from repro_torch.common.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_head=256,
    d_ff=0, vocab=50304,
    xlstm=XLSTMConfig(slstm_every=6, proj_factor=2.0, conv1d_kernel=4,
                      chunk=256),
)
