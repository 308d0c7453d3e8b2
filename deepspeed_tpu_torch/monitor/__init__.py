from deepspeed_tpu_torch.monitor.monitor import CSVMonitor, Event, Monitor

__all__ = ["CSVMonitor", "Event", "Monitor"]
