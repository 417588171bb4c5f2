"""repro_torch.train — optimizer, train step, fault-tolerant loop."""
from .loop import LoopStats, train_loop
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .trainstep import init_train_state, make_shard_ctx, make_train_step
