from .optimizers import (OptState, adafactor_init, adafactor_update,
                         adamw_init, adamw_update, make_optimizer)
from .schedules import cosine_schedule, make_schedule, wsd_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "make_optimizer", "cosine_schedule",
           "wsd_schedule", "make_schedule"]
