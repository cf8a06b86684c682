"""REST API layer.

Analog of cc/servlet/ (SURVEY.md §2h): the 19-endpoint HTTP surface with
User-Task-ID async semantics, the user task manager with per-endpoint
retention, and the 2-step verification purgatory.
"""

from cruise_control_torch.servlet.user_tasks import UserTaskManager
from cruise_control_torch.servlet.purgatory import Purgatory, ReviewStatus

__all__ = ["Purgatory", "ReviewStatus", "UserTaskManager"]
