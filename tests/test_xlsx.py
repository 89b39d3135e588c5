"""The dependency-free OOXML writer (utils/xlsx.py) behind the reference's
.xlsx result tables (reference general_utils.py:61-77): container layout,
cell contents (numbers, strings incl. XML-escaping, NaN as blank), and the
write_results integration that emits both .xlsx and the .csv merge source."""

import zipfile
import xml.etree.ElementTree as ET

import numpy as np
import pandas as pd

from gasfm.utils.xlsx import write_xlsx

_COLS = ["Scene", "repro", "note"]


def _sheet_rows(path):
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        assert {"[Content_Types].xml", "_rels/.rels", "xl/workbook.xml",
                "xl/_rels/workbook.xml.rels", "xl/worksheets/sheet1.xml"} <= names
        root = ET.fromstring(z.read("xl/worksheets/sheet1.xml"))
    rows = []
    for row in root.iter(f"{ns}row"):
        cells = {}
        for c in row.iter(f"{ns}c"):
            ref = c.attrib["r"]
            t = c.attrib.get("t")
            if t == "inlineStr":
                cells[ref] = c.find(f"{ns}is/{ns}t").text
            else:
                cells[ref] = float(c.find(f"{ns}v").text)
        rows.append(cells)
    return rows


def test_write_xlsx_cells(tmp_path):
    rows = [["s1", 1.5, "a"], ["s2", np.nan, "x<y&z"], ["Mean", 3.0, "ok"]]
    path = tmp_path / "t.xlsx"
    write_xlsx(str(path), _COLS, rows)
    rows = _sheet_rows(path)
    assert rows[0] == {"A1": "Scene", "B1": "repro", "C1": "note"}
    assert rows[1]["A2"] == "s1" and rows[1]["B2"] == 1.5 and rows[1]["C2"] == "a"
    assert "B3" not in rows[2]  # NaN -> blank cell
    assert rows[2]["C3"] == "x<y&z"  # XML-escaped round trip
    assert rows[3] == {"A4": "Mean", "B4": 3.0, "C4": "ok"}


def test_write_results_emits_both(tmp_path, monkeypatch):
    from gasfm.config import ConfigFactory
    from gasfm.utils.observability import write_results

    monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
    conf = ConfigFactory.parse_string('exp_dir = "x"')
    write_results(conf, [{"Scene": "a", "v": 1.0}, {"Scene": "b", "v": 2.0}], file_name="Res")
    import os

    exp = None
    for root, _, files in os.walk(tmp_path):
        if "Res.xlsx" in files:
            exp = root
    assert exp is not None
    rows = _sheet_rows(os.path.join(exp, "Res.xlsx"))
    assert rows[1]["B2"] == 1.0
    back = pd.read_csv(os.path.join(exp, "Res.csv")).set_index("Scene")
    assert list(back["v"]) == [1.0, 2.0]


def test_write_xlsx_infinities_as_inline_strings(tmp_path):
    """float('inf') must not land in a numeric <v> cell ('<v>inf</v>' is
    invalid OOXML — Excel/openpyxl report the file corrupt); it is written
    as an inline string like pandas' to_excel does."""
    path = str(tmp_path / "inf.xlsx")
    write_xlsx(path, ["Scene", "metric"], [["a", np.inf], ["b", -np.inf], ["c", 2.0]])
    rows = _sheet_rows(path)
    assert rows[1]["B2"] == "inf"
    assert rows[2]["B3"] == "-inf"
    assert rows[3]["B4"] == 2.0
