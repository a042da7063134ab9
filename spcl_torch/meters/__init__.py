from .metric import Metric
from .averagemeter import AverageValueListMeter, AverageValueMeter, MultipleAverageValueMeter
from .meter_interface import MeterInterface
from .display import meter_display

__all__ = ["Metric", "AverageValueMeter", "AverageValueListMeter",
           "MultipleAverageValueMeter", "MeterInterface", "meter_display"]
