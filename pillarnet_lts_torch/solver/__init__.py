from .optim import OptaxAdamW, build_optimizer, one_cycle_schedules

__all__ = ["OptaxAdamW", "build_optimizer", "one_cycle_schedules"]
