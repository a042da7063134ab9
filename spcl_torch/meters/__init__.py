from .metric import Metric
from .averagemeter import AverageValueListMeter, AverageValueMeter, MultipleAverageValueMeter
from .meter_interface import MeterInterface
from .display import meter_display
from .dice import UniversalDice, dice_stats_from_labels
from .storage import Storage

__all__ = ["Metric", "AverageValueMeter", "AverageValueListMeter",
           "MultipleAverageValueMeter", "MeterInterface", "meter_display",
           "UniversalDice", "dice_stats_from_labels", "Storage"]
