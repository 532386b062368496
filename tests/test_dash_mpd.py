"""DASH MPD parser (ext/dash) — transcription of the upstream
tests/check/elements/dash_mpd.c cases over io/dashmpd.py (same XML
strings, same expected values, including the reference's non-calendar
duration conversion year=365d / month=30d)."""

import pytest

from gstbad.io import dashmpd as mpd

MPD_HDR = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           '     profiles="urn:mpeg:dash:profile:isoff-main:2011">')


def duration_to_ms(y, mo, d, h, mi, s, ms):
    """The unit test's own helper (dash_mpd.c:64-76)."""
    days = y * 365 + mo * 30 + d
    return (((days * 24 + h) * 60 + mi) * 60 + s) * 1000 + ms


def test_validsimplempd():
    root = mpd.parse_mpd(MPD_HDR + " </MPD>")
    assert root.type == mpd.FILE_TYPE_STATIC


def test_mpd_attributes():
    """dash_mpdparser_mpd (dash_mpd.c:115-200)."""
    xml = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           ' profiles="urn:mpeg:dash:profile:isoff-main:2011"'
           ' schemaLocation="TestSchemaLocation"'
           ' xmlns:xsi="TestNamespaceXSI"'
           ' xmlns:ext="TestNamespaceEXT"'
           ' id="testId"'
           ' type="static"'
           ' availabilityStartTime="2015-03-24T1:10:50"'
           ' availabilityEndTime="2015-03-24T1:10:50.123456"'
           ' mediaPresentationDuration="P0Y1M2DT12H10M20.5S"'
           ' minimumUpdatePeriod="P0Y1M2DT12H10M20.5S"'
           ' minBufferTime="P0Y1M2DT12H10M20.5S"'
           ' timeShiftBufferDepth="P0Y1M2DT12H10M20.5S"'
           ' suggestedPresentationDelay="P0Y1M2DT12H10M20.5S"'
           ' maxSegmentDuration="P0Y1M2DT12H10M20.5S"'
           ' maxSubsegmentDuration="P0Y1M2DT12H10M20.5S"></MPD>')
    root = mpd.parse_mpd(xml)
    assert root.default_namespace == "urn:mpeg:dash:schema:mpd:2011"
    assert root.namespace_xsi == "TestNamespaceXSI"
    assert root.namespace_ext == "TestNamespaceEXT"
    assert root.schemaLocation == "TestSchemaLocation"
    assert root.id == "testId"
    assert root.type == mpd.FILE_TYPE_STATIC
    t = root.availabilityStartTime
    assert (t.year, t.month, t.day, t.hour, t.minute, t.second,
            t.microsecond) == (2015, 3, 24, 1, 10, 50, 0)
    t = root.availabilityEndTime
    assert t.microsecond == 123456
    expect = duration_to_ms(0, 1, 2, 12, 10, 20, 500)
    for attr in ("mediaPresentationDuration", "minimumUpdatePeriod",
                 "minBufferTime", "timeShiftBufferDepth",
                 "suggestedPresentationDelay", "maxSegmentDuration",
                 "maxSubsegmentDuration"):
        assert getattr(root, attr) == expect, attr


def test_datetime_with_tz_offset():
    dt = mpd.parse_datetime("2015-03-24T1:10:50+01:30")
    assert dt.tzoffset_minutes == 90
    dt = mpd.parse_datetime("2015-03-24T1:10:50-04:30")
    assert dt.tzoffset_minutes == -270
    dt = mpd.parse_datetime("2015-03-24T1:10:50Z")
    assert dt.tzoffset_minutes == 0


def test_program_information():
    xml = MPD_HDR + (
        '<ProgramInformation lang="en"'
        ' moreInformationURL="TestMoreInformationUrl">'
        '<Title>TestTitle</Title>'
        '<Source>TestSource</Source>'
        '<Copyright>TestCopyright</Copyright>'
        '</ProgramInformation></MPD>')
    pi = mpd.parse_mpd(xml).ProgramInfos[0]
    assert pi.lang == "en"
    assert pi.moreInformationURL == "TestMoreInformationUrl"
    assert (pi.Title, pi.Source, pi.Copyright) == \
        ("TestTitle", "TestSource", "TestCopyright")


def test_baseurl_and_location():
    xml = MPD_HDR + (
        '<BaseURL serviceLocation="TestServiceLocation"'
        ' byteRange="TestByteRange">TestBaseURL</BaseURL>'
        '<Location>TestLocation</Location></MPD>')
    root = mpd.parse_mpd(xml)
    b = root.BaseURLs[0]
    assert (b.baseURL, b.serviceLocation, b.byteRange) == \
        ("TestBaseURL", "TestServiceLocation", "TestByteRange")
    assert root.Locations == ["TestLocation"]


def test_metrics():
    xml = MPD_HDR + (
        '<Metrics metrics="TestMetric">'
        '<Range starttime="P0Y1M2DT12H10M20.5S"'
        '       duration="P0Y1M2DT12H10M20.1S"/>'
        '<Reporting schemeIdUri="TestSchemeIdUri" value="TestValue"/>'
        '</Metrics></MPD>')
    m = mpd.parse_mpd(xml).Metrics[0]
    assert m.metrics == "TestMetric"
    assert m.Range[0].starttime == duration_to_ms(0, 1, 2, 12, 10,
                                                  20, 500)
    assert m.Range[0].duration == duration_to_ms(0, 1, 2, 12, 10,
                                                 20, 100)
    assert m.Reporting[0].schemeIdUri == "TestSchemeIdUri"
    assert m.Reporting[0].value == "TestValue"


def test_period():
    """dash_mpdparser_period: fractional seconds truncate to ms."""
    xml = MPD_HDR + (
        '<Period id="TestId"'
        ' start="P0Y1M2DT12H10M20.1234567S"'
        ' duration="P0Y1M2DT12H10M20.7654321S"'
        ' bitstreamSwitching="true"></Period></MPD>')
    p = mpd.parse_mpd(xml).Periods[0]
    assert p.id == "TestId"
    assert p.start == duration_to_ms(0, 1, 2, 12, 10, 20, 123)
    assert p.duration == duration_to_ms(0, 1, 2, 12, 10, 20, 765)
    assert p.bitstreamSwitching


def test_period_segment_base():
    xml = MPD_HDR + (
        '<Period><SegmentBase timescale="123456"'
        ' presentationTimeOffset="123456789"'
        ' indexRange="100-200"'
        ' indexRangeExact="true">'
        '<Initialisation sourceURL="TestSourceURL" range="100-200"/>'
        '<RepresentationIndex sourceURL="TestSourceURL2"'
        ' range="300-400"/>'
        '</SegmentBase></Period></MPD>')
    sb = mpd.parse_mpd(xml).Periods[0].SegmentBase
    assert sb.timescale == 123456
    assert sb.presentationTimeOffset == 123456789
    assert sb.indexRange == (100, 200)
    assert sb.indexRangeExact
    assert sb.Initialization.sourceURL == "TestSourceURL"
    assert sb.Initialization.range == (100, 200)
    assert sb.RepresentationIndex.sourceURL == "TestSourceURL2"
    assert sb.RepresentationIndex.range == (300, 400)


def test_period_segment_list():
    xml = MPD_HDR + (
        '<Period><SegmentList duration="10" startNumber="11"'
        ' timescale="12" presentationTimeOffset="13">'
        '<SegmentTimeline><S t="1" d="2" r="3"/>'
        '<S d="4"/></SegmentTimeline>'
        '<SegmentURL media="TestMedia" mediaRange="100-200"'
        ' index="TestIndex" indexRange="300-400"/>'
        '</SegmentList></Period></MPD>')
    sl = mpd.parse_mpd(xml).Periods[0].SegmentList
    assert (sl.duration, sl.startNumber, sl.timescale,
            sl.presentationTimeOffset) == (10, 11, 12, 13)
    assert [(s.t, s.d, s.r) for s in sl.SegmentTimeline.S] == \
        [(1, 2, 3), (-1, 4, 0)]
    u = sl.SegmentURL[0]
    assert (u.media, u.mediaRange, u.index, u.indexRange) == \
        ("TestMedia", (100, 200), "TestIndex", (300, 400))


def test_period_segment_template():
    xml = MPD_HDR + (
        '<Period><SegmentTemplate media="TestMedia"'
        ' index="TestIndex" initialization="TestInitialization"'
        ' bitstreamSwitching="TestBitstreamSwitching"'
        ' duration="10" startNumber="11" timescale="12">'
        '</SegmentTemplate></Period></MPD>')
    st = mpd.parse_mpd(xml).Periods[0].SegmentTemplate
    assert st.media == "TestMedia"
    assert st.index == "TestIndex"
    assert st.initialization == "TestInitialization"
    assert st.bitstreamSwitching == "TestBitstreamSwitching"
    assert (st.duration, st.startNumber, st.timescale) == (10, 11, 12)


def test_adaptation_set_representation_base():
    """dash_mpdparser_period_adaptationSet_representationBase."""
    xml = MPD_HDR + (
        '<Period><AdaptationSet profiles="TestProfiles"'
        ' width="100" height="200" sar="10:20" frameRate="30/40"'
        ' audioSamplingRate="TestAudioSamplingRate"'
        ' mimeType="TestMimeType"'
        ' segmentProfiles="TestSegmentProfiles" codecs="TestCodecs"'
        ' maximumSAPPeriod="3.4" startWithSAP="0" maxPlayoutRate="1.2"'
        ' codingDependency="false" scanType="progressive">'
        '</AdaptationSet></Period></MPD>')
    a = mpd.parse_mpd(xml).Periods[0].AdaptationSets[0]
    assert a.profiles == "TestProfiles"
    assert (a.width, a.height) == (100, 200)
    assert a.sar == (10, 20)
    assert a.frameRate == (30, 40)
    assert a.audioSamplingRate == "TestAudioSamplingRate"
    assert a.mimeType == "TestMimeType"
    assert a.segmentProfiles == "TestSegmentProfiles"
    assert a.codecs == "TestCodecs"
    assert a.maximumSAPPeriod == pytest.approx(3.4)
    assert a.startWithSAP == 0
    assert a.maxPlayoutRate == pytest.approx(1.2)
    assert not a.codingDependency
    assert a.scanType == "progressive"


def test_adaptation_set_descriptors():
    xml = MPD_HDR + (
        '<Period><AdaptationSet>'
        '<Accessibility schemeIdUri="TestSchemeIdUri"'
        ' value="TestValue"/>'
        '<Role schemeIdUri="TestRole" value="main"/>'
        '<Rating schemeIdUri="TestRating" value="5"/>'
        '<Viewpoint schemeIdUri="TestViewpoint" value="vp"/>'
        '</AdaptationSet></Period></MPD>')
    a = mpd.parse_mpd(xml).Periods[0].AdaptationSets[0]
    assert a.Accessibility[0].schemeIdUri == "TestSchemeIdUri"
    assert a.Accessibility[0].value == "TestValue"
    assert a.Role[0].value == "main"
    assert a.Rating[0].value == "5"
    assert a.Viewpoint[0].value == "vp"


def test_content_protection_no_value():
    """dash_mpdparser_contentProtection_no_value: the child payload is
    kept when value is absent."""
    xml = MPD_HDR + (
        '<Period><AdaptationSet>'
        '<ContentProtection schemeIdUri="urn:uuid:9a04f079">'
        '<mspr:pro xmlns:mspr="urn:microsoft:playready">'
        'blahblah</mspr:pro>'
        '</ContentProtection>'
        '</AdaptationSet></Period></MPD>')
    a = mpd.parse_mpd(xml).Periods[0].AdaptationSets[0]
    cp = a.ContentProtection[0]
    assert cp.schemeIdUri == "urn:uuid:9a04f079"
    assert cp.value is None
    assert "blahblah" in cp.text


def test_content_component():
    xml = MPD_HDR + (
        '<Period><AdaptationSet>'
        '<ContentComponent id="1" lang="en" contentType="TestType"'
        ' par="10:20"/>'
        '</AdaptationSet></Period></MPD>')
    cc = mpd.parse_mpd(xml).Periods[0].AdaptationSets[0] \
        .ContentComponents[0]
    assert (cc.id, cc.lang, cc.contentType, cc.par) == \
        (1, "en", "TestType", (10, 20))


def test_representation_and_sub():
    xml = MPD_HDR + (
        '<Period><AdaptationSet>'
        '<Representation id="Test_Id" bandwidth="100"'
        ' qualityRanking="200" dependencyId="one,two,three"'
        ' mediaStreamStructureId="four,five,six">'
        '<SubRepresentation level="100" dependencyLevel="1 2 3"'
        ' bandwidth="200" contentComponent="content1,content2"/>'
        '</Representation>'
        '</AdaptationSet></Period></MPD>')
    r = mpd.parse_mpd(xml).Periods[0].AdaptationSets[0] \
        .Representations[0]
    assert r.id == "Test_Id"
    assert r.bandwidth == 100
    assert r.qualityRanking == 200
    assert r.dependencyId == ["one", "two", "three"]
    assert r.mediaStreamStructureId == ["four", "five", "six"]
    s = r.SubRepresentations[0]
    assert s.level == 100
    assert s.dependencyLevel == [1, 2, 3]
    assert s.bandwidth == 200
    assert s.contentComponent == ["content1", "content2"]


def test_period_subset():
    xml = MPD_HDR + '<Period><Subset contains="1 2 3"/></Period></MPD>'
    assert mpd.parse_mpd(xml).Periods[0].Subsets[0].contains == \
        [1, 2, 3]


def test_utctiming():
    """dash_mpdparser_utctiming (+invalid scheme dropped)."""
    xml = MPD_HDR + (
        '<UTCTiming schemeIdUri="urn:mpeg:dash:utc:http-xsdate:2014"'
        ' value="http://time.server/a http://time.server/b"/>'
        '<UTCTiming schemeIdUri="urn:not:a:scheme" value="x"/>'
        '</MPD>')
    root = mpd.parse_mpd(xml)
    assert len(root.UTCTimings) == 1
    ut = root.UTCTimings[0]
    assert ut.method == "http-xsdate"
    assert ut.values == ["http://time.server/a",
                         "http://time.server/b"]


def test_type_dynamic():
    xml = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           ' profiles="urn:mpeg:dash:profile:isoff-main:2011"'
           ' type="dynamic"></MPD>')
    assert mpd.parse_mpd(xml).type == mpd.FILE_TYPE_DYNAMIC


def test_template_parsing():
    """dash_mpdparser_template_parsing: the full upstream table."""
    cases = [
        ("", None),
        ("$$", "$"),
        ("Number", "Number"),
        ("Number$Number$", "Number7"),
        ("Number$Number$$$", "Number7$"),
        ("Number$Number$Number$Number$", "Number7Number7"),
        ("Representation$RepresentationID$", "RepresentationTestId"),
        ("TestMedia$Bandwidth$$$test", "TestMedia2500$test"),
        ("TestMedia$Time$", "TestMedia100"),
        ("TestMedia$Time", None),
        ("Time$Time%d$", None),
        ("Time$Time%0d$", "Time100"),
        ("Time$Time%01d$", "Time100"),
        ("Time$Time%05d$", "Time00100"),
        ("Time$Time%05dtest$", "Time00100test"),
        ("Time$Time%3d$", None),
        ("Time$Time%0-4d$", None),
        ("Time$Time%0$", None),
        ("Time$Time1%01d$", None),
        ("$Bandwidth%/init.mp4v", None),
        ("$Number%/$Time$.mp4v", None),
        ("$RepresentationID1$", None),
        ("$Bandwidth1$", None),
        ("$Number1$", None),
        ("$RepresentationID%01d$", None),
        ("Time$Time%05u$", None),
        ("Time$Time%05x$", None),
        ("Time$Time%05utest$", None),
        ("Time$Time%05xtest$", None),
        ("Time$Time%05xtest%$", None),
    ]
    for template, expect in cases:
        got = mpd.build_url_from_template(template, "TestId", 7, 2500,
                                          100)
        assert got == expect, (template, got, expect)


def test_duration_validation():
    """dash_mpdparser_duration: the full upstream validity table."""
    invalid = ["", " ", "0", "D-1", "T", "PX", "PPT", "PTT", "P1D1D",
               "P1D1M", "P1M1D1M", "P1M1D1D", "P-1M", "P15M", "P-1D",
               "P35D", "P-1Y", "PT-1H", "PT25H", "PT-1M", "PT65M",
               "PT-1S", "PT1.1H", "PT1-1H", "PT1-H", "PT-H", "PTH",
               "PT0", "PT1.1.1S", "P585Y", "P10D T8H"]
    valid = ["P", "PT", "P1D", "P1M1D", "P0M0D", "PT65S", "PT1.1S",
             "P584Y", " P10DT8H", "P10DT8H "]
    for s in invalid:
        with pytest.raises(mpd.MpdError):
            mpd.parse_duration(s)
    for s in valid:
        mpd.parse_duration(s)


def test_various_duration_formats():
    """dash_mpdparser_various_duration_formats: comma decimals, every
    unit."""
    xml = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           ' profiles="urn:mpeg:dash:profile:isoff-main:2011"'
           ' availabilityStartTime="2015-03-24T0:0:0"'
           ' mediaPresentationDuration="P100Y">'
           '<Period id="Period0" start="PT1S"></Period>'
           '<Period id="Period1" start="PT1.5S"></Period>'
           '<Period id="Period2" start="PT1,7S"></Period>'
           '<Period id="Period3" start="PT1M"></Period>'
           '<Period id="Period4" start="PT1H"></Period>'
           '<Period id="Period5" start="P1D"></Period>'
           '<Period id="Period6" start="P1M"></Period>'
           '<Period id="Period7" start="P1Y"></Period></MPD>')
    root = mpd.parse_mpd(xml)
    starts = [p.start for p in root.Periods]
    assert starts == [1000, 1500, 1700, 60000, 3600000,
                      duration_to_ms(0, 0, 1, 0, 0, 0, 0),
                      duration_to_ms(0, 1, 0, 0, 0, 0, 0),
                      duration_to_ms(1, 0, 0, 0, 0, 0, 0)]


def test_missing_and_malformed():
    """missing_xml / missing_mpd / no_end_tag."""
    for xml in ("", '<?xml version="1.0"?>',
                '<?xml version="1.0"?><NPD></NPD>',
                '<?xml version="1.0"?><MPD></NPD>'):
        with pytest.raises(mpd.MpdError):
            mpd.parse_mpd(xml)


# ---------------------------------------------------------------- client

PERIODS_XML = ('<?xml version="1.0"?>'
               '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
               ' profiles="urn:mpeg:dash:profile:isoff-main:2011"'
               ' availabilityStartTime="2015-03-24T0:0:0"'
               ' mediaPresentationDuration="P0Y0M1DT1H4M3S">'
               '<Period id="Period0" duration="P0Y0M1DT1H1M1S">'
               '</Period>'
               '<Period id="Period1"></Period>'
               '<Period id="Period2" start="P0Y0M1DT1H3M3S"></Period>'
               '</MPD>')


def test_period_selection():
    """dash_mpdparser_period_selection."""
    client = mpd.MpdClient(PERIODS_XML)
    assert client.periods == []
    assert client.setup_media_presentation()
    assert len(client.periods) == 3
    assert client.current_period().period.id == "Period0"
    assert client.set_period_index(1)
    assert client.current_period().period.id == "Period1"
    assert client.set_period_index(2)
    assert client.current_period().period.id == "Period2"
    assert not client.has_next_period()
    assert client.has_previous_period()
    assert client.set_period_index(0)
    assert client.has_next_period()
    assert not client.has_previous_period()


def test_get_period_at_time():
    """dash_mpdparser_get_period_at_time (times relative to
    availabilityStartTime 2015-03-24T0:0:0)."""
    client = mpd.MpdClient(PERIODS_XML)
    assert client.setup_media_presentation()
    # before availabilityStartTime -> period 0
    assert client.get_period_at_time(-30 * 60 * 1000) == 0
    # inside period 0 (23h30m59s after start)
    assert client.get_period_at_time(
        duration_to_ms(0, 0, 0, 23, 30, 59, 0)) == 0
    # inside period 1 (1d1h1m1s)
    assert client.get_period_at_time(
        duration_to_ms(0, 0, 1, 1, 1, 1, 0)) == 1
    # inside period 2 (1d1h3m3s)
    assert client.get_period_at_time(
        duration_to_ms(0, 0, 1, 1, 3, 3, 0)) == 2
    # after mediaPresentationDuration -> G_MAXUINT analog
    assert client.get_period_at_time(
        duration_to_ms(0, 0, 1, 1, 4, 3, 0)) == -1


def test_negative_period_duration():
    """dash_mpdparser_negative_period_duration: setup fails."""
    xml = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           ' profiles="urn:mpeg:dash:profile:isoff-main:2011"'
           ' availabilityStartTime="2015-03-24T0:0:0"'
           ' mediaPresentationDuration="P0Y0M0DT3H3M30S">'
           '<Period id="Period0" start="P0Y0M0DT1H0M0S"'
           ' duration="-PT10S"></Period>'
           '<Period id="Period1"></Period></MPD>')
    client = mpd.MpdClient(xml)
    assert not client.setup_media_presentation()


def test_representation_selection():
    """dash_mpdparser_representation_selection."""
    xml = MPD_HDR.replace(">", ">") + (
        '<Period id="Period0" duration="P0Y0M1DT1H1M1S">'
        '<AdaptationSet id="1" mimeType="video/mp4">'
        '<Representation id="v0" bandwidth="500000"></Representation>'
        '<Representation id="v1" bandwidth="250000"></Representation>'
        '</AdaptationSet></Period></MPD>')
    client = mpd.MpdClient(xml)
    assert client.setup_media_presentation()
    aset = client.current_period().period.AdaptationSets[0]
    assert aset.id == 1
    reps = aset.Representations
    assert client.representation_index_with_min_bandwidth(reps) == 1
    assert client.representation_index_with_max_bandwidth(reps, 0) == 1
    assert client.representation_index_with_max_bandwidth(
        reps, 100000) == -1
    assert client.representation_index_with_max_bandwidth(
        reps, 300000) == 1
    assert client.representation_index_with_max_bandwidth(
        reps, 500000) == 0


def test_get_audio_languages():
    """dash_mpdparser_get_audio_languages."""
    xml = MPD_HDR + (
        '<Period id="Period0" duration="P0Y0M1DT1H1M1S">'
        '<AdaptationSet id="1" mimeType="audio" lang="en">'
        '<Representation id="1" bandwidth="250000"></Representation>'
        '</AdaptationSet>'
        '<AdaptationSet id="2" mimeType="video/mp4">'
        '<Representation id="2" bandwidth="250000"></Representation>'
        '</AdaptationSet>'
        '<AdaptationSet id="3" mimeType="audio" lang="fr">'
        '<Representation id="3" bandwidth="250000"></Representation>'
        '</AdaptationSet></Period></MPD>')
    client = mpd.MpdClient(xml)
    assert client.setup_media_presentation()
    assert client.get_audio_languages() == ["en", "fr"]


def test_isoff_ondemand_profile():
    xml = ('<?xml version="1.0"?>'
           '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           ' profiles="urn:mpeg:dash:profile:isoff-on-demand:2011">'
           '</MPD>')
    root = mpd.parse_mpd(xml)
    assert "isoff-on-demand" in root.profiles
