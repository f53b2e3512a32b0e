"""Experiment-tracking adapters.

PyTorch counterpart of gesturediffusion_tpu/train/platforms.py.  NoPlatform
is the default; the TensorBoard and ClearML adapters need their optional
packages and say so when they are missing.
"""

from __future__ import annotations

import os


class TrainPlatform:
    def __init__(self, save_dir: str):
        pass

    def report_scalar(self, name, value, iteration, group_name=None):
        pass

    def report_args(self, args, name):
        pass

    def close(self):
        pass


class NoPlatform(TrainPlatform):
    pass


def _missing(platform: str, package: str, err: ImportError) -> ImportError:
    return ImportError(f"{platform} needs the {package!r} package, which is not "
                       f"installed ({err}); use --train_platform_type NoPlatform")


class TensorboardPlatform(TrainPlatform):
    def __init__(self, save_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise _missing("TensorboardPlatform", "tensorboard", e) from e
        self.writer = SummaryWriter(log_dir=save_dir)

    def report_scalar(self, name, value, iteration, group_name=None):
        self.writer.add_scalar(f"{group_name}/{name}", value, iteration)

    def close(self):
        self.writer.close()


class ClearmlPlatform(TrainPlatform):
    def __init__(self, save_dir: str):
        try:
            from clearml import Task
        except ImportError as e:
            raise _missing("ClearmlPlatform", "clearml", e) from e
        name = os.path.basename(os.path.normpath(save_dir))
        self.task = Task.init(project_name="gesturediffusion_tpu", task_name=name)
        self.logger = self.task.get_logger()

    def report_scalar(self, name, value, iteration, group_name=None):
        self.logger.report_scalar(title=group_name, series=name, iteration=iteration,
                                  value=value)

    def report_args(self, args, name):
        self.task.connect(args, name=name)

    def close(self):
        self.task.close()


def create_platform(name: str, save_dir: str) -> TrainPlatform:
    table = {
        "NoPlatform": NoPlatform,
        "TensorboardPlatform": TensorboardPlatform,
        "ClearmlPlatform": ClearmlPlatform,
    }
    return table[name](save_dir)
